"""The batched SFU media plane in PyTorch, with hand-written CUDA kernels
for NVIDIA Hopper (H100).

A port of `livekit_server_tpu` (JAX, the reference). The layout mirrors
the reference package so each counterpart is easy to find:

  - ops/      leaf algebra (seqnum, bits, selector, allocation, rtpstats,
              streamtracker, audio, bwe, pacer, red, quality); the two
              phase-0/phase-2 kernels live in ops/selector.py and
              ops/allocation.py, their CUDA sources in csrc/
  - models/   the dense media-plane tick (plane.py) and seeded traffic
              (synth.py)
  - runtime/  ingest staging, host munging, probe control and the
              trimmed dense PlaneRuntime

The package imports torch and numpy only; it never imports jax or the
reference package. Entry points take `device=` and default to "cuda";
without a card they raise rather than fall back to the CPU.
"""
