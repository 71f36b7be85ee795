"""The control: the reference tick computed one precision below the plane's.

The plane states float32 for its float leaves (rates, levels, EMAs,
budgets) and runs no matrix product, so TF32 changes nothing in it; the
nearest precision below float32 that does is bfloat16. `tick_bf16` runs
the reference tick with every float leaf of the state and the inputs
rounded to bfloat16 on the way in, and every float leaf of the new state
and the outputs rounded on the way out: bfloat16 storage between the
tick's steps. Put in the program's place at a cell's own size, it has to
come out as not correct (sfu_bench/control.py runs it; the benchmark's
own runs never do).
"""

from __future__ import annotations

import torch

from . import tick


def _round(tree):
    def r(x):
        if torch.is_tensor(x) and x.dtype == torch.float32:
            return x.to(torch.bfloat16).to(torch.float32)
        return x
    return tick.tree_map(r, tree)


def tick_bf16(state, inp, *args, **kwargs):
    """`tick.media_plane_tick` over bfloat16-rounded float leaves; takes
    and returns NamedTuple trees with the tick's fields (of either
    package's classes)."""
    new_state, out = tick.media_plane_tick(_round(state), _round(inp), *args, **kwargs)
    return _round(new_state), _round(out)
