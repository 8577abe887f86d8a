"""Adam as optax writes it, and its non-finite-gradient guard (port of
weaklysuperviseddl_tpu/train/guard.py wrapped around optax.adam).

``Adam`` is optax's update: m = β1·m + (1−β1)·g, v = β2·v + (1−β2)·g²,
p −= lr·(m/(1−β1^t)) / (sqrt(v/(1−β2^t)) + eps), t counted from 1. The step
count ``count`` is a 0-dim int32 tensor on the parameters' device and the
bias corrections 1 − β^t are computed there in float32 (optax's
``1 - decay**count``), so a step reads nothing back and can be captured in a
CUDA graph.

``GuardedAdam`` is JAX's ``apply_if_finite_fast``: one fp32 sum over all
gradients detects NaN and ±inf (a NaN propagates into it, a lone ±inf makes
it ±inf, +inf and −inf together make it NaN). The decision is a device
tensor: a step whose sum is not finite keeps the parameters, both moments
and the step count bit for bit (an exact ``torch.where`` select over each
flat buffer: the old moments and count, and an update of +0; the counters
``notfinite_count`` and ``total_notfinite`` are 0-dim int32 device tensors
too). After ``MAX_CONSECUTIVE_ERRORS`` non-finite steps
in a row the update passes through unprotected, so a run that has diverged for
good surfaces as NaN parameters instead of silently training nothing.

On a mesh (``group``: every rank of it) the decision is the whole mesh's:
each rank flags its own gradients, which under tensor parallelism are only
its shards of some of them, the flags are summed by an all-reduce on the
device, and a flag on any rank skips the step on every rank, so the ranks'
parameters never part.
"""

from __future__ import annotations

import torch
import torch.distributed

B1, B2, EPS = 0.9, 0.999, 1e-8      # optax.adam's defaults
MAX_CONSECUTIVE_ERRORS = 100        # optax.apply_if_finite's escape hatch


def _counter(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


class Adam:
    """Adam over parameters of one dtype and device. The moments live in two
    flat buffers (``m`` and ``v`` are views of them, one a parameter), so an
    update is a few whole-buffer operations and a guarded step's select is
    one ``torch.where`` a buffer."""

    def __init__(self, params, lr: float = 1e-3):
        self.params = list(params)
        if len({(p.dtype, p.device) for p in self.params}) > 1:
            raise ValueError("Adam takes parameters of one dtype and device")
        self.lr, self.b1, self.b2, self.eps = lr, B1, B2, EPS
        self._shapes = [p.shape for p in self.params]
        self._numels = [p.numel() for p in self.params]
        like = self.params[0] if self.params else torch.zeros(0)
        self._place(torch.zeros(sum(self._numels), dtype=like.dtype, device=like.device),
                    torch.zeros(sum(self._numels), dtype=like.dtype, device=like.device),
                    _counter(like.device))

    def _place(self, flat_m, flat_v, count):
        self._flat_m, self._flat_v, self._count = flat_m, flat_v, count  # count: Adam's t
        self.m, self.v = self._views(flat_m), self._views(flat_v)
        self._decay = None           # [β1, β2] on the moments' device, made at first use

    def _views(self, flat: torch.Tensor) -> list[torch.Tensor]:
        return [t.view(s) for t, s in zip(flat.split(self._numels), self._shapes)]

    def to(self, device):
        """Move the moments and the counters to ``device`` (the parameters
        move with their module)."""
        self._place(self._flat_m.to(device), self._flat_v.to(device), self._count.to(device))
        return self

    # the counters are 0-dim device tensors updated in place (a captured
    # graph holds their addresses); assigning an int writes it into them
    @property
    def count(self) -> torch.Tensor:
        return self._count

    @count.setter
    def count(self, value):
        _assign(self._count, value)

    def _grads(self):
        return [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]

    def _bias_corrections(self, count: torch.Tensor):
        """(1 − β1^t, 1 − β2^t) on the device, t = ``count``: float32, as
        optax computes them, or float64 for float64 moments (optax's under
        ``jax.enable_x64``)."""
        dtype = torch.float64 if self._flat_m.dtype == torch.float64 else torch.float32
        if self._decay is None:      # copied to the device once, never in a capture
            self._decay = torch.tensor([self.b1, self.b2], dtype=dtype, device=count.device)
        bc = 1.0 - torch.pow(self._decay, count.to(dtype))
        return bc[0], bc[1]

    @torch.no_grad()
    def _apply(self, g: torch.Tensor, apply: torch.Tensor | None = None):
        """One Adam step from the flat gradient ``g`` (the parameters' order);
        with ``apply`` (a 0-dim bool device tensor) the new moments, count
        and update are selected where it is true, and where it is false the
        moments and count are kept and the parameters move by +0: all bit
        for bit."""
        count = self._count + 1
        bc1, bc2 = self._bias_corrections(count)
        m = self._flat_m.mul(self.b1).add_(g.mul(1.0 - self.b1))
        v = self._flat_v.mul(self.b2).add_(g.mul(g).mul_(1.0 - self.b2))
        update = m.div(bc1).div_(v.div(bc2).sqrt_().add_(self.eps)).mul_(self.lr)
        if apply is None:
            self._flat_m.copy_(m)
            self._flat_v.copy_(v)
            self._count.copy_(count)
        else:
            torch.where(apply, m, self._flat_m, out=self._flat_m)
            torch.where(apply, v, self._flat_v, out=self._flat_v)
            torch.where(apply, count, self._count, out=self._count)
            update = torch.where(apply, update, 0.0)   # p − (+0) is p, −0 and NaN too
        torch._foreach_sub_(self.params, self._views(update))

    def _flat_grads(self) -> torch.Tensor:
        return torch.cat([g.reshape(-1) for g in self._grads()])

    def step(self):
        """Apply the update from each parameter's ``.grad``."""
        self._apply(self._flat_grads())
        return True

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        """The moments (as lists aligned with the parameters, views of the
        flat buffers) and the step count (a copy of the 0-dim tensor), as
        ``torch.load(weights_only=True)`` reads them back."""
        return {"m": list(self.m), "v": list(self.v), "count": self._count.clone()}

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        """Copy a ``state_dict()`` into this optimizer's moments and counters
        (on their own device). It must come from an optimizer over parameters
        of the same shapes in the same order. Counters may be 0-dim tensors or
        Python ints (snapshots written before the counters moved to the
        device hold ints)."""
        for name in ("m", "v"):
            mine, theirs = getattr(self, name), state[name]
            if len(mine) != len(theirs) or any(a.shape != b.shape for a, b in zip(mine, theirs)):
                raise ValueError(f"optimizer state {name!r} does not fit these parameters")
            for a, b in zip(mine, theirs):
                a.copy_(b)
        self.count = state["count"]


def _assign(counter: torch.Tensor, value):
    """Write a Python int or a 0-dim tensor into a 0-dim counter, in place."""
    with torch.no_grad():
        if isinstance(value, torch.Tensor):
            counter.copy_(value)
        else:
            counter.fill_(int(value))


class GuardedAdam(Adam):
    def __init__(self, params, lr: float = 1e-4, group=None):
        super().__init__(params, lr)
        self.group = group                           # a mesh's ranks decide together
        self._notfinite = _counter(self._count.device)        # consecutive non-finite steps
        self._total_notfinite = _counter(self._count.device)  # lifetime non-finite steps

    @property
    def notfinite_count(self) -> torch.Tensor:
        return self._notfinite

    @notfinite_count.setter
    def notfinite_count(self, value):
        _assign(self._notfinite, value)

    @property
    def total_notfinite(self) -> torch.Tensor:
        return self._total_notfinite

    @total_notfinite.setter
    def total_notfinite(self, value):
        _assign(self._total_notfinite, value)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Apply the update unless the gradients are not finite. Returns
        whether it was applied, as a 0-dim bool device tensor: nothing is read
        back."""
        g = self._flat_grads()
        finite = torch.isfinite(g.float().sum())
        if self.group is not None:
            flags = (~finite).float()
            torch.distributed.all_reduce(flags, group=self.group)
            finite = flags == 0
        apply = finite | (self._notfinite >= MAX_CONSECUTIVE_ERRORS)
        self._notfinite.copy_(torch.where(finite, 0, self._notfinite + 1))
        self._total_notfinite.add_((~finite).to(torch.int32))
        self._apply(g, apply)
        return apply

    def to(self, device):
        super().to(device)
        self._notfinite = self._notfinite.to(device)
        self._total_notfinite = self._total_notfinite.to(device)
        return self

    def state_dict(self) -> dict:
        return {**super().state_dict(), "notfinite_count": self._notfinite.clone(),
                "total_notfinite": self._total_notfinite.clone()}

    def load_state_dict(self, state: dict):
        super().load_state_dict(state)
        self.notfinite_count = state["notfinite_count"]
        self.total_notfinite = state["total_notfinite"]
