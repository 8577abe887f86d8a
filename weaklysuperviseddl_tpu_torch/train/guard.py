"""Adam as optax writes it, and its non-finite-gradient guard (port of
weaklysuperviseddl_tpu/train/guard.py wrapped around optax.adam).

``Adam`` is optax's update: m = β1·m + (1−β1)·g, v = β2·v + (1−β2)·g²,
p −= lr·(m/(1−β1^t)) / (sqrt(v/(1−β2^t)) + eps), t counted from 1.

``GuardedAdam``: one fp32 sum over all gradients detects NaN and ±inf (a NaN
propagates into it, a lone ±inf makes it ±inf, +inf and −inf together make
it NaN). A step whose sum is not finite applies no update and leaves the Adam
state untouched, step count included (``torch.optim.Adam`` would count a
skipped step, so these classes keep their own). After
``MAX_CONSECUTIVE_ERRORS`` non-finite steps in a row the update passes
through unprotected, so a run that has diverged for good surfaces as NaN
parameters instead of silently training nothing.
"""

from __future__ import annotations

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8      # optax.adam's defaults
MAX_CONSECUTIVE_ERRORS = 100        # optax.apply_if_finite's escape hatch


class Adam:
    def __init__(self, params, lr: float = 1e-3):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, B1, B2, EPS
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.count = 0  # applied steps (Adam's t)

    def _grads(self):
        return [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def _apply(self, grads):
        # multi-tensor ops: a few launches per step for all parameters, where a
        # loop over DeepLabV3-ResNet50's tensors issues about ten small kernels
        # for each of them
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        torch._foreach_mul_(self.m, self.b1)
        torch._foreach_add_(self.m, torch._foreach_mul(grads, 1.0 - self.b1))
        torch._foreach_mul_(self.v, self.b2)
        torch._foreach_add_(self.v, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                       1.0 - self.b2))
        denom = torch._foreach_sqrt(torch._foreach_div(self.v, bc2))
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(torch._foreach_div(self.m, bc1), denom)
        torch._foreach_sub_(self.params, torch._foreach_mul(update, self.lr))

    def step(self) -> bool:
        """Apply the update from each parameter's ``.grad``."""
        self._apply(self._grads())
        return True

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        """The moments (as lists aligned with the parameters) and the step
        count, as tensors and Python ints (``torch.load(weights_only=True)``
        reads them back)."""
        return {"m": list(self.m), "v": list(self.v), "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        """Copy a ``state_dict()`` into this optimizer's moments (on their own
        device) and counters. It must come from an optimizer over parameters
        of the same shapes in the same order."""
        for name in ("m", "v"):
            mine, theirs = getattr(self, name), state[name]
            if len(mine) != len(theirs) or any(a.shape != b.shape for a, b in zip(mine, theirs)):
                raise ValueError(f"optimizer state {name!r} does not fit these parameters")
            for a, b in zip(mine, theirs):
                a.copy_(b)
        self.count = int(state["count"])


class GuardedAdam(Adam):
    def __init__(self, params, lr: float = 1e-4):
        super().__init__(params, lr)
        self.notfinite_count = 0   # consecutive non-finite steps
        self.total_notfinite = 0   # lifetime non-finite steps

    def step(self) -> bool:
        """Apply the update unless the gradients are not finite; returns
        whether it was applied. Reads the gradient sum back (one sync)."""
        grads = self._grads()
        with torch.no_grad():
            total = torch.cat([g.reshape(-1).float() for g in grads]).sum()
        finite = bool(torch.isfinite(total))
        apply = finite or self.notfinite_count >= MAX_CONSECUTIVE_ERRORS
        self.notfinite_count = 0 if finite else self.notfinite_count + 1
        self.total_notfinite += 0 if finite else 1
        if apply:
            self._apply(grads)
        return apply

    def state_dict(self) -> dict:
        return {**super().state_dict(), "notfinite_count": self.notfinite_count,
                "total_notfinite": self.total_notfinite}

    def load_state_dict(self, state: dict):
        super().load_state_dict(state)
        self.notfinite_count = int(state["notfinite_count"])
        self.total_notfinite = int(state["total_notfinite"])
