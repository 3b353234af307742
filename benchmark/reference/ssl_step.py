"""Plain float32 DINOv2 SSL train step (TF32 off), written from the recipe:
the teacher's forward of the global crops with the crops' order swapped, the
DINO head (an MLP with exact GELUs, L2 normalisation, weight-normalised
prototypes), softmax centring of the teacher's outputs with the centres'
EMA; the student's forwards of the global crops (their masked patches
replaced by the mask token) and of the local crops, each with drop-path
masks from its own generator; the DINO loss over local and global crops, the
KoLeo regulariser of each global crop group, the iBOT loss of the masked
patches; the clip of each submodule's gradient norm, AdamW with the
layer-wise learning-rate decay and the weight-decay rules, and the teacher's
EMA.

The backbone runs in blocks of crops so that it fits: first without
gradients to reach the heads and the losses, whose gradients with respect
to the backbone's outputs are then carried back through each block of crops
run again with gradients. The recipe's randomness (the generator of each
iteration, split into one for the global and one for the local crops) is
drawn again from the seed the benchmark hands both sides.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

from benchmark.reference import octic_vit
from benchmark.reference.leaves import leaf_norms

BACKBONE, HEAD = "backbone.", "dino_head."


def iteration_seed(seed: int, it: int) -> int:
    return ((seed + 1) * 1_000_003 + it) % (2 ** 63)


def drop_masks(gen: torch.Generator, depth: int, batch: int, rate: float, device) -> list:
    keep = 1.0 - rate
    out = []
    for _ in range(depth):
        pair = []
        for _ in range(2):
            u = torch.rand((batch,), generator=gen)
            pair.append(((u < keep).float() / keep).to(device).reshape(batch, 1, 1))
        out.append(tuple(pair))
    return out


def head(p: Dict[str, torch.Tensor], x: torch.Tensor, layers: int, q: Callable) -> torch.Tensor:
    for i in range(layers):
        x = octic_vit.linear(x, p[f"{HEAD}mlp_{i}.weight"], p[f"{HEAD}mlp_{i}.bias"], q)
        if i < layers - 1:
            x = F.gelu(x)
    x = x / (x.norm(dim=-1, keepdim=True) + 1e-12)
    v, g = p[HEAD + "last_layer.v"], p[HEAD + "last_layer.g"]
    w = v / torch.sqrt(v.square().sum(0, keepdim=True) + 1e-12) * g[None, :]
    return torch.matmul(q(x), q(w))


def koleo(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Kozachenko-Leonenko: minus the mean log distance of each normalised row
    to its nearest other row."""
    x = x / (x.norm(dim=-1, keepdim=True) + eps)
    dots = x @ x.t() - 2.0 * torch.eye(x.shape[0], device=x.device)
    diffs = x - x[dots.argmax(1)]
    return -torch.log(torch.sqrt(diffs.square().sum(-1) + eps * eps) + eps).mean()


def multipliers(name: str, depth: int, rule: dict) -> tuple:
    """(lr multiplier, weight-decay multiplier, 1 for the prototype layer)."""
    layer = depth + 1
    if any(k in name for k in ("pos_embed", "patch_embed", "mask_token", "cls_token",
                               "register_tokens")):
        layer = 0
    else:
        m = re.search(r"blocks\.(\d+)", name)
        if m:
            layer = int(m.group(1)) + 1
    lr = rule["layerwise_decay"] ** (depth + 1 - layer)
    if "patch_embed" in name:
        lr *= rule["patch_embed_lr_mult"]
    leaf = name.rsplit(".", 1)[-1]
    no_wd = leaf in ("bias", "bias_a1", "beta_a1") or any(
        s in name for s in ("norm", "gamma", "alpha"))
    return lr, 0.0 if no_wd else 1.0, 1.0 if "last_layer" in name else 0.0


def _sub(p: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {n[len(prefix):]: t for n, t in p.items() if n.startswith(prefix)}


def backbone_out(bb: Dict[str, torch.Tensor], cfg: dict, images, masks, token_masks, q,
                 chunk: int) -> torch.Tensor:
    """The normed tokens of every crop, block by block of `chunk` crops."""
    outs = []
    for s in range(0, images.shape[0], chunk):
        e = s + chunk
        mk = None if masks is None else [(a[s:e], c[s:e]) for a, c in masks]
        tm = None if token_masks is None else token_masks[s:e]
        outs.append(octic_vit.features(bb, cfg, images[s:e], q, mk, tm))
    return torch.cat(outs)


def run(p0: Dict[str, torch.Tensor], cfg: dict, recipe: dict, batches: List[dict], seed: int,
        q: Callable = octic_vit.ident, chunk: int = 16, local_chunk: int = 64) -> dict:
    """Steps from the student weights `p0` (the teacher starts as their copy)
    on the collated `batches`. Returns each step's total loss, each student
    parameter's gradient norm as AdamW got it at the first step, each
    parameter's change after the last step, and each teacher parameter's."""
    names = list(p0)
    depth, layers = cfg["depth"], cfg["dino_head_nlayers"]
    temp_s, n_g = recipe["student_temp"], 2
    student = {n: t.detach().clone() for n, t in p0.items()}
    teacher = {n: t.detach().clone() for n, t in p0.items()}
    mu = {n: torch.zeros_like(t) for n, t in p0.items()}
    nu = {n: torch.zeros_like(t) for n, t in p0.items()}
    k_out = p0[HEAD + "last_layer.g"].shape[0]
    dev = p0[HEAD + "last_layer.g"].device
    dino_c = torch.zeros(k_out, device=dev)
    ibot_c = torch.zeros(k_out, device=dev)
    b1, b2 = recipe["betas"]
    mults = {n: multipliers(n, depth, recipe) for n in names}
    losses, first_grad = [], None
    for i, batch in enumerate(batches):
        it = recipe["start_iter"] + i
        gen = torch.Generator().manual_seed(iteration_seed(seed, it))
        gseed = torch.randint(0, 2 ** 62, (2,), generator=gen)
        gen_g = torch.Generator().manual_seed(int(gseed[0]))
        gen_l = torch.Generator().manual_seed(int(gseed[1]))
        gc, lc = batch["global_crops"].float(), batch["local_crops"].float()
        tmask, idx, w = batch["masks"], batch["mask_indices"], batch["masks_weight"]
        two_b = gc.shape[0]
        b = two_b // n_g
        n_l = lc.shape[0] // b
        tt = recipe["teacher_temp"]
        with torch.no_grad():
            t_tok = backbone_out(_sub(teacher, BACKBONE), cfg, gc, None, None, q, chunk)
            t_cls = torch.cat((t_tok[b:, 0], t_tok[:b, 0]))
            t_masked = t_tok[:, 1:].reshape(-1, t_tok.shape[-1])[idx]
            del t_tok
            t_after = head(teacher, torch.cat((t_cls, t_masked)), layers, q)
            t_dino = torch.softmax((t_after[:two_b] - dino_c) / tt, dim=-1)
            t_ibot = torch.softmax((t_after[two_b:] - ibot_c) / tt, dim=-1)
            cm = recipe["center_momentum"]
            valid = (w > 0).float()[:, None]
            new_dino_c = dino_c * cm + t_after[:two_b].mean(0) * (1 - cm)
            new_ibot_c = ibot_c * cm + ((t_after[two_b:] * valid).sum(0)
                                        / valid.sum().clamp(min=1.0)) * (1 - cm)
            del t_after
        bb = {n: t.requires_grad_(True) for n, t in _sub(student, BACKBONE).items()}
        hd = {n: student[n].requires_grad_(True) for n in names if n.startswith(HEAD)}
        gmask = drop_masks(gen_g, depth, two_b, recipe["drop_path"], dev)
        lmask = drop_masks(gen_l, depth, lc.shape[0], recipe["drop_path"], dev)
        with torch.no_grad():
            s_g = backbone_out(bb, cfg, gc, gmask, tmask, q, chunk)
            s_l = backbone_out(bb, cfg, lc, lmask, None, q, local_chunk)
        s_cls_g = s_g[:, 0].clone().requires_grad_(True)
        s_masked = s_g[:, 1:].reshape(-1, s_g.shape[-1])[idx].clone().requires_grad_(True)
        s_cls_l = s_l[:, 0].clone().requires_grad_(True)
        n_patch = s_g.shape[1] - 1
        del s_g, s_l
        after = head(hd, torch.cat((s_cls_l, s_cls_g, s_masked)), layers, q)
        nl_b = s_cls_l.shape[0]
        lsm_l = torch.log_softmax(after[:nl_b] / temp_s, -1).reshape(n_l, b, -1)
        t_groups = t_dino.reshape(n_g, b, -1)
        terms = (n_g - 1) * n_g + n_l * n_g
        dino_local = sum(-(t * s).sum(-1).mean() for s in lsm_l for t in t_groups) / terms
        lsm_g = torch.log_softmax(after[nl_b:nl_b + two_b] / temp_s, -1)
        dino_global = -(t_dino * lsm_g).sum(-1).mean() * 2.0 / terms
        kl = recipe["koleo_loss_weight"] * sum(koleo(x) for x in s_cls_g.reshape(n_g, b, -1))
        lsm_p = torch.log_softmax(after[nl_b + two_b:] / temp_s, -1)
        ibot = -((t_ibot * lsm_p).sum(-1) * w).sum() / two_b * 2.0 / n_g
        total = dino_local + dino_global + kl + ibot
        total.backward()
        losses.append(float(total.detach()))
        del after, lsm_l, lsm_g, lsm_p, total
        # carry the outputs' gradients back through the backbone, block by block
        g_patch = torch.zeros(two_b * n_patch, s_masked.shape[-1], device=dev)
        g_patch.index_add_(0, idx, s_masked.grad)
        g_patch = g_patch.reshape(two_b, n_patch, -1)
        for images, masks, tm, g_cls, g_tok, step in (
                (gc, gmask, tmask, s_cls_g.grad, g_patch, chunk),
                (lc, lmask, None, s_cls_l.grad, None, local_chunk)):
            for s in range(0, images.shape[0], step):
                e = s + step
                out = octic_vit.features(bb, cfg, images[s:e], q,
                                         [(a[s:e], c[s:e]) for a, c in masks],
                                         None if tm is None else tm[s:e])
                grad = torch.zeros_like(out)
                grad[:, 0] = g_cls[s:e]
                if g_tok is not None:
                    grad[:, 1:] = g_tok[s:e]
                out.backward(grad)
        with torch.no_grad():
            grads = {n: (student[n].grad if student[n].grad is not None
                         else torch.zeros_like(student[n])) for n in names}
            for prefix in (BACKBONE, HEAD):
                group = [grads[n] for n in names if n.startswith(prefix)]
                gn = torch.linalg.vector_norm(torch.stack([g.norm() for g in group]))
                scale = torch.clamp(recipe["clip_grad"] / (gn + 1e-6), max=1.0)
                for g in group:
                    g.mul_(scale)
            if first_grad is None:
                first_grad = leaf_norms(grads.items())
            t = i + 1
            for n in names:
                p, g = student[n], grads[n]
                lr_m, wd_m, last = mults[n]
                mu[n].mul_(b1).add_(g, alpha=1 - b1)
                nu[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (mu[n] / (1 - b1 ** t)) / ((nu[n] / (1 - b2 ** t)).sqrt() + 1e-8)
                upd = upd + recipe["wd"] * wd_m * p
                lr = recipe["last_layer_lr"] * last + recipe["lr"] * (1 - last)
                p.sub_(upd * (lr * lr_m))
                p.grad = None
                p.requires_grad_(False)
                teacher[n].mul_(recipe["momentum"]).add_(p, alpha=1 - recipe["momentum"])
            dino_c, ibot_c = new_dino_c, new_ibot_c
    with torch.no_grad():
        change = leaf_norms((n, student[n] - p0[n]) for n in names)
        t_change = leaf_norms((n, teacher[n] - p0[n]) for n in names)
    return {"losses": losses, "grad": first_grad, "change": change, "teacher_change": t_change}
