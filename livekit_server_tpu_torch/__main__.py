import sys

from livekit_server_tpu_torch.cli import main

sys.exit(main())
