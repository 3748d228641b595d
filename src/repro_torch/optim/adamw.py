"""AdamW and SGD with momentum on trees of tensors — port of
`repro.optim.adamw`.

Parameters, gradients and state are nested dicts of tensors with the same
structure.  The state's type is an argument: float32, or bfloat16 moments
for the large configs so that the optimizer state fits beside the weights
(the reference's choice at full width; `--debug` runs float32).  Master
weights stay in the parameter type; the update is computed in float32 and
cast back, as the reference does.  The bias corrections ``1 − b1^t`` and
``1 − b2^t`` are float32 powers of the float32 step count, as XLA computes
them, not Python doubles.  Elementwise PyTorch: the reference has no kernel
here.

The update writes the new values into the parameters and the state in
place and returns them, as the reference's jit does with the buffers it is
donated (its functions return new trees), so a training step holds one
copy of each.  Each leaf is updated in slices of at most `SLICE` elements,
so the float32 temporaries of a large leaf (gemma3-4b's 671M-element
embedding) stay small; the operations are elementwise IEEE ones, so the
slicing changes no bit.
"""
from __future__ import annotations

import torch

from ..core.pytree import tree_leaves, tree_map

#: elements of a leaf updated at a time
SLICE = 1 << 24


def _update(fn, outs: tuple, *ins) -> None:
    """``outs[i][s] = fn(*(x[s] for x in outs + ins))[i]`` over slices s of
    the flattened leaves: `fn` maps slices of the leaf, its state and its
    gradient to the float32 slices of their new values."""
    flat = [x.view(-1) for x in outs] + [x.reshape(-1) for x in ins]
    for s in range(0, flat[0].numel(), SLICE):
        res = fn(*(x[s:s + SLICE] for x in flat))
        for y, r in zip(flat, res):
            y[s:s + SLICE] = r


def _zeros(params, state_dtype):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=state_dtype, device=p.device), params)


def _step0(params):
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)


def adamw_init(params, state_dtype=torch.float32):
    return {"m": _zeros(params, state_dtype), "v": _zeros(params, state_dtype),
            "step": _step0(params)}


@torch.no_grad()
def adamw_update(grads, opt_state, params, lr: float = 3e-4, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1):
    """One AdamW step, in place: returns (params, state), updated."""
    step = opt_state["step"] + 1
    t = step.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=t.device), t)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=t.device), t)

    def upd(p, m, v, g):
        g32 = g.to(torch.float32)
        m_new = b1 * m.to(torch.float32) + (1 - b1) * g32
        v_new = b2 * v.to(torch.float32) + (1 - b2) * g32 * g32
        mhat = m_new / c1
        vhat = v_new / c2
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.to(torch.float32)
        p_new = p.to(torch.float32) - lr * delta
        return p_new, m_new, v_new

    tree_map(lambda p, m, v, g: _update(upd, (p, m, v), g), params, opt_state["m"],
             opt_state["v"], grads)
    return params, {"m": opt_state["m"], "v": opt_state["v"], "step": step}


def sgdm_init(params, state_dtype=torch.float32):
    return {"mom": _zeros(params, state_dtype), "step": _step0(params)}


@torch.no_grad()
def sgdm_update(grads, opt_state, params, lr: float = 1e-2, momentum: float = 0.9):
    """One step of SGD with momentum, in place: returns (params, state),
    updated."""
    def upd(p, m, g):
        m_new = momentum * m.to(torch.float32) + g.to(torch.float32)
        return p.to(torch.float32) - lr * m_new, m_new

    tree_map(lambda p, m, g: _update(upd, (p, m), g), params, opt_state["mom"], grads)
    return params, {"mom": opt_state["mom"], "step": opt_state["step"] + 1}
