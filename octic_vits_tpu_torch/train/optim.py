"""LAMB written to ``optax.lamb``'s semantics (the DeiT III pretraining
optimizer; the JAX package takes it from optax, the reference from apex).

Per parameter tensor and step t (counting from 1):
    m = b1 m + (1 - b1) g          v = b2 v + (1 - b2) g^2
    u = (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t) + eps_root) + eps)
    u = u + wd p                   (decoupled decay; wd per param group)
    r = |p| / |u|, or 1 where either norm is 0
    p = p - lr r u
Parameters without a gradient are skipped (their moments never start),
which is what zeroed gradients and masked updates amount to in the JAX
step's ``trainable_mask``. The update runs as ``torch._foreach_*`` ops over
each group's tensors: a few launches per group instead of a dozen per
tensor (the octic model has ~600 parameter tensors).

Under FSDP2 the parameters, gradients and moments are DTensor shards: the
arithmetic runs on the local shards, and |p| and |u| are the norms of the
whole tensors (``parallel.sharding.norms``), as optax's trust ratio is per
whole tensor; a shard's own norm would give each process another ratio.
"""

from __future__ import annotations

import torch

from octic_vits_tpu_torch.parallel.sharding import local, norms


class Lamb(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 1e-3, betas: tuple = (0.9, 0.999), eps: float = 1e-6,
                 eps_root: float = 0.0, weight_decay: float = 0.0):
        defaults = dict(lr=lr, betas=betas, eps=eps, eps_root=eps_root, weight_decay=weight_decay)
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            grads, ms, vs, bc1, bc2 = [], [], [], [], []
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                st["step"] += 1
                grads.append(local(p.grad))
                ms.append(local(st["exp_avg"]))
                vs.append(local(st["exp_avg_sq"]))
                bc1.append(1 - b1 ** st["step"])
                bc2.append(1 - b2 ** st["step"])
            whole = params  # for the norms of whole tensors
            params = [local(p) for p in params]
            torch._foreach_mul_(ms, b1)
            torch._foreach_add_(ms, grads, alpha=1 - b1)
            torch._foreach_mul_(vs, b2)
            torch._foreach_addcmul_(vs, grads, grads, value=1 - b2)
            den = torch._foreach_div(vs, bc2)
            if group["eps_root"]:
                torch._foreach_add_(den, group["eps_root"])
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, group["eps"])
            u = torch._foreach_div(ms, bc1)
            torch._foreach_div_(u, den)
            if group["weight_decay"]:
                torch._foreach_add_(u, params, alpha=group["weight_decay"])
            pn = norms(whole)
            un = norms(u, like=whole)
            trust = torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un)
            torch._foreach_mul_(u, list((trust * -group["lr"]).unbind()))
            torch._foreach_add_(params, u)
        return loss

