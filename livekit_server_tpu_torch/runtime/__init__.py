"""Host runtime of the port: slot allocation, ingest staging, host munging,
probe control, the dense single-device PlaneRuntime, and the failure and
overload plane (supervisor, integrity, governor, faultinject)."""

from livekit_server_tpu_torch.runtime.ingest import IngestBuffer
from livekit_server_tpu_torch.runtime.plane_runtime import PlaneRuntime
from livekit_server_tpu_torch.runtime.slots import CapacityError, SlotAllocator

__all__ = ["CapacityError", "IngestBuffer", "PlaneRuntime", "SlotAllocator"]
