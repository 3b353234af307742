"""DINOv2 SSL meta-architecture (counterpart of
octic_vits_tpu/train/dinov2/ssl_meta_arch.py): student and teacher, the
DINO, iBOT and KoLeo losses, and one train step with per-submodule clipping,
AdamW with per-parameter lr and weight-decay multipliers, the teacher EMA
and the center EMAs.

The teacher runs in ``eval()`` under ``no_grad``, so its octic blocks take
the fused inference kernels; the student runs in ``train()`` with drop path
and, for an octic backbone, the fused qkv + attention op whose backward is
the K-lin-d8-bwd chain (``fuse_qkv``, the JAX package's accelerator flags).
Drop-path masks come from an explicit ``torch.Generator``: the step draws
one stream for the global-crop pass and one for the local-crop pass
(:func:`split_student_generators`). ``state_shardings``,
``batch_shardings`` and the per-device KoLeo scope wait for the port's data
parallelism; the port runs on one device, where the KoLeo neighbours are
searched over the whole batch, as the JAX step does without a mesh.

    arch = SSLMetaArch(SSLConfig(), device="cuda")
    state = arch.init(torch.Generator("cuda").manual_seed(0))
    step = arch.make_train_step()
    state, metrics = step(state, batch_to_device(batch, "cuda"), sched,
                          torch.Generator().manual_seed(1))
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from octic_vits_tpu_torch.layers.init import init_weights
from octic_vits_tpu_torch.models.dino_head import DINOHead
from octic_vits_tpu_torch.models.registry import create_model, resolve_device
from octic_vits_tpu_torch.train.dinov2 import losses as L
from octic_vits_tpu_torch.train.dinov2.param_groups import build_multiplier_trees


@dataclasses.dataclass(frozen=True)
class SSLConfig:
    arch: str = "hybrid_dinov2_vit_large_patch16"
    img_size: int = 224
    local_crop_size: int = 96
    patch_size: int = 16
    drop_path_rate: float = 0.3
    # dino
    dino_out_dim: int = 65536
    dino_head_hidden_dim: int = 2048
    dino_head_bottleneck_dim: int = 256
    dino_head_nlayers: int = 3
    dino_loss_weight: float = 1.0
    koleo_loss_weight: float = 0.1
    # ibot
    do_ibot: bool = True
    ibot_separate_head: bool = False
    ibot_out_dim: int = 65536
    ibot_loss_weight: float = 1.0
    # temperatures and centering ("centering" or "sinkhorn_knopp")
    student_temp: float = 0.1
    center_momentum: float = 0.9
    centering: str = "centering"
    # crops
    n_global_crops: int = 2
    n_local_crops: int = 8
    # optimizer
    adamw_beta1: float = 0.9
    adamw_beta2: float = 0.999
    clip_grad: float = 3.0
    layerwise_decay: float = 0.9
    patch_embed_lr_mult: float = 0.2
    # activations' dtype over f32 parameters (None: the parameters' dtype)
    compute_dtype: Optional[torch.dtype] = torch.bfloat16
    backbone_remat: bool = False


@dataclasses.dataclass
class SSLState:
    step: int
    student: nn.ModuleDict        # {"backbone", "dino_head"[, "ibot_head"]}
    teacher: nn.ModuleDict        # the same structure, no gradients
    mu: Dict[str, torch.Tensor]   # AdamW moments by student parameter name (f32)
    nu: Dict[str, torch.Tensor]
    dino_center: torch.Tensor     # [dino_out_dim] f32
    ibot_center: torch.Tensor     # [ibot_out_dim] f32


def split_student_generators(generator: Optional[torch.Generator]) -> tuple:
    """Two generators, for the global-crop and the local-crop student
    passes, seeded from `generator` (the JAX step folds 1 and 2 into its
    key): the two passes draw distinct drop-path masks."""
    if generator is None:
        return None, None
    seeds = torch.randint(0, 2**62, (2,), generator=generator, device=generator.device)
    return tuple(torch.Generator(generator.device).manual_seed(int(s)) for s in seeds)


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The numpy batch of ``collate_crops_and_masks`` as tensors on `device`."""
    out = {k: torch.as_tensor(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}
    out["mask_indices"] = out["mask_indices"].long()
    return out


class SSLMetaArch:
    """Builds the student and its state, the loss and the train step, on
    `device` (the CUDA card when none is given; without a card that raises,
    see ``models.registry.resolve_device``). Keyword arguments beyond the
    config go to the backbone's constructor (``init_scale=1.0`` for a check
    whose LayerScales must not hide the blocks)."""

    def __init__(self, cfg: SSLConfig, device=None, **backbone_overrides):
        self.cfg = cfg
        device = resolve_device(device)
        self.device = device
        octic = cfg.arch.startswith(("hybrid", "d8"))
        self.backbone_kwargs = dict(
            img_size=cfg.img_size, drop_path_rate=cfg.drop_path_rate,
            compute_dtype=cfg.compute_dtype, remat=cfg.backbone_remat, device=device,
            **(dict(fuse_qkv=True) if octic else {}), **backbone_overrides)

    # ---- modules and state ------------------------------------------------

    def build_student(self) -> nn.ModuleDict:
        """The student's modules, parameters uninitialised (f32)."""
        cfg = self.cfg
        backbone = create_model(cfg.arch, **self.backbone_kwargs)

        def head(out_dim):
            return DINOHead(backbone.embed_dim, out_dim, cfg.dino_head_hidden_dim,
                            cfg.dino_head_bottleneck_dim, cfg.dino_head_nlayers,
                            device=self.device)

        modules = {"backbone": backbone, "dino_head": head(cfg.dino_out_dim)}
        if cfg.do_ibot and cfg.ibot_separate_head:
            modules["ibot_head"] = head(cfg.ibot_out_dim)
        return nn.ModuleDict(modules)

    def init(self, generator: torch.Generator) -> SSLState:
        student = self.build_student()
        init_weights(student, generator)
        return self.state_from_student(student)

    def state_from_student(self, student: nn.ModuleDict) -> SSLState:
        """A fresh state around `student`: the teacher starts as its copy,
        the moments and the centers at zero."""
        cfg = self.cfg
        teacher = copy.deepcopy(student).requires_grad_(False)
        mu = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in student.named_parameters()}
        nu = {n: torch.zeros_like(t) for n, t in mu.items()}
        dev = next(student.parameters()).device
        return SSLState(0, student, teacher, mu, nu,
                        torch.zeros(cfg.dino_out_dim, device=dev),
                        torch.zeros(cfg.ibot_out_dim, device=dev))

    # ---- loss -------------------------------------------------------------

    def loss_fn(self, student: nn.ModuleDict, teacher: nn.ModuleDict,
                dino_center: torch.Tensor, ibot_center: torch.Tensor,
                batch: Dict[str, torch.Tensor], teacher_temp: float,
                generator: Optional[torch.Generator] = None) -> tuple:
        """(total loss, aux) with aux = {"loss_dict", "dino_center",
        "ibot_center"}; the order of the JAX ``loss_fn``."""
        cfg = self.cfg
        gen_g, gen_l = split_student_generators(generator)
        dt = cfg.compute_dtype or torch.float32
        gc = batch["global_crops"].to(dt)
        lc = batch["local_crops"].to(dt)
        masks = batch["masks"]
        mask_indices = batch["mask_indices"]
        masks_weight = batch["masks_weight"]
        mask_valid = masks_weight > 0
        two_b = gc.shape[0]
        b = two_b // cfg.n_global_crops
        do_ibot, shared = cfg.do_ibot, not cfg.ibot_separate_head
        n_g_terms = (cfg.n_global_crops - 1) * cfg.n_global_crops
        n_l_terms = max(cfg.n_local_crops * cfg.n_global_crops, 1)

        # ---------------- teacher (no grad, eval mode) ----------------
        teacher.eval()
        with torch.no_grad():
            t_out = teacher["backbone"].forward_features(gc)
            t_cls = t_out["x_norm_clstoken"]
            t_cls = torch.cat((t_cls[b:], t_cls[:b]))  # crop A is matched with crop B
            t_patch = t_out["x_norm_patchtokens"]
            t_masked = t_patch.reshape(-1, t_patch.shape[-1])[mask_indices]
            t_patch_after = None
            if do_ibot and shared:
                t_after = teacher["dino_head"](torch.cat((t_cls, t_masked)))
                t_cls_after, t_patch_after = t_after[:two_b], t_after[two_b:]
            else:
                t_cls_after = teacher["dino_head"](t_cls)
                if do_ibot:
                    t_patch_after = teacher["ibot_head"](t_masked)

            t_ibot_probs, new_ibot_center = None, ibot_center
            if cfg.centering == "centering":
                t_dino_probs = L.softmax_center_teacher(t_cls_after, dino_center, teacher_temp)
                new_dino_center = L.update_center(L.CenterState(dino_center), t_cls_after,
                                                  cfg.center_momentum).center
                if do_ibot:
                    t_ibot_probs = L.softmax_center_teacher(t_patch_after, ibot_center,
                                                            teacher_temp)
                    new_ibot_center = L.update_center(L.CenterState(ibot_center), t_patch_after,
                                                      cfg.center_momentum, mask_valid).center
            elif cfg.centering == "sinkhorn_knopp":
                t_dino_probs = L.sinkhorn_knopp_teacher(t_cls_after, teacher_temp)
                new_dino_center = dino_center
                if do_ibot:
                    t_ibot_probs = L.sinkhorn_knopp_teacher(t_patch_after, teacher_temp,
                                                            sample_mask=mask_valid)
            else:
                raise NotImplementedError(cfg.centering)
            t_dino_groups = t_dino_probs.reshape(cfg.n_global_crops, b, -1)

        # ---------------- student ----------------
        student.train()
        s_out_g = student["backbone"].forward_features(gc, masks, gen_g)
        s_out_l = student["backbone"].forward_features(lc, None, gen_l)
        s_cls_g = s_out_g["x_norm_clstoken"]
        s_cls_l = s_out_l["x_norm_clstoken"]
        s_patch = s_out_g["x_norm_patchtokens"]
        s_masked = s_patch.reshape(-1, s_patch.shape[-1])[mask_indices]
        pieces = [s_cls_l, s_cls_g] + ([s_masked] if do_ibot and shared else [])
        packed_after = student["dino_head"](torch.cat(pieces))
        nl_b = s_cls_l.shape[0]
        s_cls_l_after = packed_after[:nl_b]
        s_cls_g_after = packed_after[nl_b:nl_b + two_b]
        s_patch_after = None
        if do_ibot:
            s_patch_after = (packed_after[nl_b + two_b:] if shared
                             else student["ibot_head"](s_masked))

        loss_dict = {}
        total = 0.0
        if cfg.n_local_crops > 0:
            local_chunks = list(s_cls_l_after.reshape(cfg.n_local_crops, b, -1).unbind(0))
            dino_local = L.dino_loss(local_chunks, list(t_dino_groups.unbind(0)),
                                     cfg.student_temp) / (n_g_terms + n_l_terms)
            loss_dict["dino_local_crops_loss"] = dino_local
            total = total + cfg.dino_loss_weight * dino_local
        loss_scales = 2.0
        dino_global = (L.dino_loss([s_cls_g_after], [t_dino_probs], cfg.student_temp)
                       * loss_scales / (n_g_terms + n_l_terms))
        loss_dict["dino_global_crops_loss"] = dino_global
        total = total + cfg.dino_loss_weight * dino_global
        if cfg.koleo_loss_weight > 0:
            koleo = cfg.koleo_loss_weight * sum(
                L.koleo_loss(chunk) for chunk in s_cls_g.reshape(cfg.n_global_crops, b, -1))
            loss_dict["koleo_loss"] = koleo / loss_scales
            total = total + koleo
        if do_ibot:
            ibot = (L.ibot_patch_loss_masked(s_patch_after, t_ibot_probs, masks_weight,
                                             n_samples=two_b, student_temp=cfg.student_temp)
                    * loss_scales * (1.0 / cfg.n_global_crops))
            loss_dict["ibot_loss"] = ibot / 2
            total = total + cfg.ibot_loss_weight * ibot
        return total, {"loss_dict": loss_dict, "dino_center": new_dino_center,
                       "ibot_center": new_ibot_center}

    def forward_backward(self, state: SSLState, batch: Dict[str, torch.Tensor],
                         teacher_temp: float, generator: Optional[torch.Generator] = None):
        """The loss and its gradients in the student's ``.grad`` (every
        parameter gets one, zeros where the loss does not reach it)."""
        state.student.zero_grad(set_to_none=True)
        loss, aux = self.loss_fn(state.student, state.teacher, state.dino_center,
                                 state.ibot_center, batch, teacher_temp, generator)
        loss.backward()
        for p in state.student.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return loss.detach(), aux

    # ---- train step -------------------------------------------------------

    def make_train_step(self):
        """``step(state, batch, sched, generator) -> (state, metrics)``;
        ``sched`` holds the host-side scalars lr, wd, last_layer_lr, momentum
        and teacher_temp of this step. The state is updated in place (the
        parameters, moments and teacher by ``torch._foreach_*`` ops) and
        returned."""
        cfg = self.cfg
        b1, b2 = cfg.adamw_beta1, cfg.adamw_beta2

        def step(state: SSLState, batch, sched, generator=None):
            student, teacher = state.student, state.teacher
            names, params = zip(*student.named_parameters())
            lr_mult, wd_mult, last = build_multiplier_trees(
                names, student["backbone"].depth, cfg.layerwise_decay, cfg.patch_embed_lr_mult)
            loss, aux = self.forward_backward(state, batch, sched["teacher_temp"], generator)
            metrics = dict(aux["loss_dict"], total_loss=loss)
            with torch.no_grad():
                # per-submodule clipping of the global gradient norm
                for key, mod in student.items():
                    grads = [p.grad for p in mod.parameters()]
                    gn = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
                    torch._foreach_mul_(grads, torch.clamp(cfg.clip_grad / (gn + 1e-6), max=1.0))
                    metrics[f"grad_norm/{key}"] = gn
                # AdamW with per-parameter lr and weight-decay multipliers
                t = state.step + 1
                bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
                grads = [p.grad for p in params]
                mu = [state.mu[n] for n in names]
                nu = [state.nu[n] for n in names]
                torch._foreach_mul_(mu, b1)
                torch._foreach_add_(mu, grads, alpha=1.0 - b1)
                torch._foreach_mul_(nu, b2)
                torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
                denom = torch._foreach_div(nu, bc2)
                torch._foreach_sqrt_(denom)
                torch._foreach_add_(denom, 1e-8)
                upd = torch._foreach_div(mu, bc1)
                torch._foreach_div_(upd, denom)
                del denom
                torch._foreach_add_(upd, torch._foreach_mul(
                    list(params), [sched["wd"] * wd_mult[n] for n in names]))
                torch._foreach_mul_(upd, [
                    (sched["last_layer_lr"] * last[n] + sched["lr"] * (1.0 - last[n])) * lr_mult[n]
                    for n in names])
                torch._foreach_sub_(list(params), upd)
                del upd
                # teacher EMA towards the updated student
                m = sched["momentum"]
                tparams = list(teacher.parameters())
                torch._foreach_mul_(tparams, m)
                torch._foreach_add_(tparams, list(params), alpha=1.0 - m)
            state.step += 1
            state.dino_center = aux["dino_center"]
            state.ibot_center = aux["ibot_center"]
            return state, metrics

        return step
