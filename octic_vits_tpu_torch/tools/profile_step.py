"""Where the time of one step goes on the card: ``torch.profiler`` over one
train step (or one inference forward) of each model of a cell, after warm-up.

    python3 -m octic_vits_tpu_torch.tools.profile_step ssl        # DINOv2, ViT-L/16, B=32
    python3 -m octic_vits_tpu_torch.tools.profile_step deit       # DeiT III, ViT-H/14, B=32
    python3 -m octic_vits_tpu_torch.tools.profile_step deit_glue  # the hybrid's DeiT step,
                                                                  # P7's flags vs path C
    python3 -m octic_vits_tpu_torch.tools.profile_step infer      # one forward, ViT-H/14,
                                                                  # B=64: P4, paths A and B
    python3 -m octic_vits_tpu_torch.tools.profile_step infer_inv  # one forward, B=64: P4's
                                                                  # hybrid, inv-early flat-E
                                                                  # and packed (P16)
    python3 -m octic_vits_tpu_torch.tools.profile_step deit_packed  # DeiT III, B=32: P7's
                                                                    # hybrid, inv-early with
                                                                    # P7's flags, packed (P17)
    python3 -m octic_vits_tpu_torch.tools.profile_step infer_wide   # one forward, B=64: P4's
                                                                    # hybrid, use_wide_qkv (P19)
    python3 -m octic_vits_tpu_torch.tools.profile_step deit_wide    # DeiT III, B=32: P7's
                                                                    # hybrid, use_wide_qkv (P20)

For each model it prints the profiled step's wall time, the device's busy
time (the sum of the kernels' device time; one stream) and idle share, the
number of kernel launches, the device time by kind (the hand-written
kernels of this package, library GEMMs, everything else), the top kernels
and every hand-written one, and last one JSON line with those numbers. The
profiler adds host time to every launch, so the profiled wall time is longer
than an unprofiled step's. The models, batches and step settings are those
of ``chip_smoke.py`` P4, P7, P10, P13 and P14 (which time the unprofiled
steps), with seeded random weights and inputs; ``deit_glue`` profiles the
hybrid with P7's flags and with path C's (plain octic linears, the D8-GELU
kernel and the D8 LayerNorm kernel), ``infer`` the hybrid with P4's flags,
paths A (``fuse_mlp_branch``) and B (``fuse_block_epilogues``), both with
the LN kernel, and the standard model; ``infer_inv`` and ``deit_packed``
the hybrid against ``d8_inv_early_deit_huge_patch14`` with the flat-E carry
and with ``packed_carry`` (in training with ``fuse_qkv`` and ``fuse_mlp``,
the packed ops' requirements); ``infer_wide`` and ``deit_wide`` the hybrid
with and without ``use_wide_qkv``. Run from the repository root (it imports
``chip_smoke``); needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from octic_vits_tpu_torch.layers import d8_layers

SEED = 0


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _ssl_cell(arch_name: str):
    import chip_smoke
    from octic_vits_tpu_torch.train.dinov2.schedules import sqrt_lr_scaling
    from octic_vits_tpu_torch.train.dinov2.ssl_meta_arch import (
        SSLConfig,
        SSLMetaArch,
        batch_to_device,
    )

    arch = SSLMetaArch(SSLConfig(arch=arch_name, backbone_remat=True))
    state = arch.init(torch.Generator("cuda").manual_seed(SEED))
    step = arch.make_train_step()
    lr = sqrt_lr_scaling(4e-3, chip_smoke.SSL_BATCH)
    sched = dict(lr=lr, wd=0.04, last_layer_lr=lr, momentum=0.992, teacher_temp=0.04)
    batch = batch_to_device(chip_smoke.ssl_batch(chip_smoke.SSL_BATCH, SEED + 5), "cuda")
    gen = torch.Generator().manual_seed(SEED + 6)
    box = [state]

    def run():
        box[0], _ = step(box[0], batch, sched, gen)

    return run


def _deit_cell(arch_name: str, **flags):
    import chip_smoke
    from octic_vits_tpu_torch import create_model, init_weights
    from octic_vits_tpu_torch.train.deit.engine import DeiTConfig

    cfg = DeiTConfig()
    model = create_model(arch_name, remat=True, drop_path_rate=cfg.drop_path,
                         compute_dtype=torch.bfloat16, **flags)
    init_weights(model, torch.Generator("cuda").manual_seed(SEED))
    state, step = chip_smoke.train_setup(model, cfg)
    gen = torch.Generator().manual_seed(SEED + 3)
    images = torch.randn(chip_smoke.TRAIN_BATCH, 224, 224, 3, generator=gen).cuda()
    labels = torch.randint(0, 1000, (chip_smoke.TRAIN_BATCH,), generator=gen).cuda()
    box = [state]

    def run():
        box[0], _ = step(box[0], images, labels, gen)

    return run


def _infer_cell(arch_name: str, **flags):
    import chip_smoke
    from octic_vits_tpu_torch import create_model, init_weights

    model = create_model(arch_name, dtype=torch.bfloat16, **flags).eval()
    init_weights(model, torch.Generator("cuda").manual_seed(SEED))
    images = torch.randn(chip_smoke.BATCH, 224, 224, 3, generator=torch.Generator().manual_seed(
        SEED + 1)).to("cuda", torch.bfloat16)

    def run():
        with torch.no_grad():
            model(images)

    return run


# cell -> (the function that makes one step, the models it compares: (architecture,
# flags, LN kernel on))
CELLS = {
    "ssl": (_ssl_cell, (("hybrid_dinov2_vit_large_patch16", {}, False),
                        ("dinov2_vit_large_patch16", {}, False))),
    "deit": (_deit_cell, (("hybrid_deit_huge_patch14", {}, False),
                          ("deit_huge_patch14_LS", {}, False))),
    "infer": (_infer_cell, (("hybrid_deit_huge_patch14", {}, False),
                            ("hybrid_deit_huge_patch14", dict(fuse_mlp_branch=True), True),
                            ("hybrid_deit_huge_patch14", dict(fuse_block_epilogues=True), True),
                            ("deit_huge_patch14_LS", {}, False))),
    "deit_glue": (_deit_cell, (("hybrid_deit_huge_patch14", {}, False),
                               ("hybrid_deit_huge_patch14",
                                dict(use_pallas_linear=False, use_pallas_gelu=True), True))),
    "infer_inv": (_infer_cell, (("hybrid_deit_huge_patch14", {}, False),
                                ("d8_inv_early_deit_huge_patch14", {}, False),
                                ("d8_inv_early_deit_huge_patch14", dict(packed_carry=True), False))),
    "deit_packed": (_deit_cell, (("hybrid_deit_huge_patch14", {}, False),
                                 ("d8_inv_early_deit_huge_patch14", {}, False),
                                 ("d8_inv_early_deit_huge_patch14",
                                  dict(packed_carry=True, fuse_qkv=True, fuse_mlp=True), False))),
    "infer_wide": (_infer_cell, (("hybrid_deit_huge_patch14", {}, False),
                                 ("hybrid_deit_huge_patch14", dict(use_wide_qkv=True), False))),
    "deit_wide": (_deit_cell, (("hybrid_deit_huge_patch14", {}, False),
                               ("hybrid_deit_huge_patch14", dict(use_wide_qkv=True), False))),
}


def _kind(name: str) -> str:
    if "ovt::" in name or name.startswith("ovt"):
        return "hand-written"
    if any(k in name.lower() for k in ("gemm", "cutlass", "xmma", "cublas", "sm90_", "nvjet")):
        return "library GEMM"
    return "other"


def profile(run, warmup: int = 3, top: int = 12) -> dict:
    from torch.profiler import ProfilerActivity, profile as torch_profile

    for _ in range(warmup):
        run()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels, launches = {}, 0
    for e in prof.key_averages():
        if e.key.startswith("cudaLaunchKernel"):
            launches += e.count
        dev = getattr(e, "self_device_time_total", 0.0)
        # ranges such as "Optimizer.step#Lamb.step" carry the device time of
        # the kernels inside them a second time: kernels only (a kernel's own
        # name may hold a "#", as in "{lambda()#3}")
        annotation = getattr(e, "is_user_annotation", False) or e.key.startswith(
            ("Optimizer.", "ProfilerStep"))
        if dev > 0 and e.device_type == torch.autograd.DeviceType.CUDA and not annotation:
            kernels[e.key] = (kernels.get(e.key, (0, 0.0))[0] + e.count,
                              kernels.get(e.key, (0, 0.0))[1] + dev / 1e3)
    busy = sum(ms for _, ms in kernels.values())
    by_kind = {}
    for name, (_, ms) in kernels.items():
        by_kind[_kind(name)] = by_kind.get(_kind(name), 0.0) + ms
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    shown = ranked[:top] + [kv for kv in ranked[top:] if _kind(kv[0]) == "hand-written"]
    return {"wall_ms": wall, "device_busy_ms": busy, "idle_share": 1.0 - busy / wall,
            "kernel_launches": launches, "by_kind_ms": by_kind,
            "top": [(name[:90], count, ms) for name, (count, ms) in shown]}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 2
    cell = sys.argv[1] if len(sys.argv) > 1 else "ssl"
    build, models = CELLS[cell]
    torch.backends.cuda.matmul.allow_tf32 = False
    card = _card()
    print(card, flush=True)
    results = {}
    for arch, flags, ln_kernel in models:
        d8_layers.OCTIC_PALLAS_LN = ln_kernel
        name = arch + "".join(f" {k}={v}" for k, v in flags.items()) + (
            " OCTIC_PALLAS_LN" if ln_kernel else "")
        res = profile(build(arch, **flags))
        results[name] = res
        print(f"{cell} {name}: wall {res['wall_ms']:.2f} ms, device busy "
              f"{res['device_busy_ms']:.2f} ms, idle share {res['idle_share']:.3f}, "
              f"{res['kernel_launches']} kernel launches; by kind (ms) "
              f"{ {k: round(v, 2) for k, v in res['by_kind_ms'].items()} }", flush=True)
        for kname, count, ms in res["top"]:
            print(f"    {ms:9.3f} ms {count:6d}x  {kname}", flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"cell": cell, "card": card, "results": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
