"""The dense media-plane tick (plane.py) and seeded synthetic traffic (synth.py)."""
