"""Chip smoke test of the PyTorch + CUDA port (octic_vits_tpu_torch) on one
NVIDIA GPU. Run from the repository root: ``python3 chip_smoke.py``.

Phases, one line each (any failure raises and exits non-zero):
  P0 device  the card's name and power limit (nvidia-smi); no CUDA -> exit 2
  P1 build   nvcc builds csrc/ into build/octic_vits_tpu_torch/
  P2 kernels each hand-written kernel against its plain PyTorch version at
             the ViT-H/14 B=64 bf16 shapes and at a ragged small shape, with
             the stated tolerance and CUDA-event median times
  P3 slice   hybrid ViT-H/14 (hybrid_deit_huge_patch14, full width and depth,
             seeded random weights, LayerScale init 1.0) forward at B=64 224^2
             bf16: finite logits, 16 launches of each kernel, and logits of two
             images against the same weights in f32 through the plain path on
             the CPU
  P4 timing  hybrid and standard (deit_huge_patch14_LS) forward, img/s
The line before the last is the per-kernel JSON summary; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

BATCH, IMG = 64, 224
SEED = 0
# bf16 kernel vs f32 plain version (both rounded to bf16 at the same points):
# |kernel - plain| <= ATOL + RTOL * |plain| elementwise. Covers one or two
# bf16 ulps of the output and the summation order of f32 accumulators.
ATOL, RTOL = 1e-2, 2e-2
# P3: relative L2 error of bf16-on-card logits against f32-on-CPU logits
# over 32 blocks of bf16 activations
SLICE_REL_TOL = 5e-2


def phase(tag: str, msg: str) -> None:
    print(f"{tag} {msg}", flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of one call of `fn` over `iters` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def randn(gen, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)


def kernel_cases(gen, b, n, c, heads, bias):
    """(name, kernel op, reference op, args) of the four kernels at one shape."""
    from octic_vits_tpu_torch import ops

    c8 = c // 8
    opt = lambda t: t if bias else None  # noqa: E731
    qkv = randn(gen, b, n, 3 * c)
    xs = tuple(randn(gen, b, n, c8) for _ in range(4)) + (randn(gen, b, n, 4 * c8),)
    wq1, wqe = randn(gen, 4, c8, 3 * c8, scale=c8 ** -0.5), randn(gen, 2 * c8, 6 * c8,
                                                                   scale=(2 * c8) ** -0.5)
    x = randn(gen, b, n, c)
    w_fc1, b_fc1 = randn(gen, 4 * c, c, scale=c ** -0.5), randn(gen, 4 * c, scale=0.1)
    h8 = 4 * c8
    w1a, wea = randn(gen, 4, c8, h8, scale=c8 ** -0.5), randn(gen, 2 * c8, 2 * h8,
                                                              scale=(2 * c8) ** -0.5)
    w1b, web = randn(gen, 4, h8, c8, scale=h8 ** -0.5), randn(gen, 2 * h8, 2 * c8,
                                                              scale=(2 * h8) ** -0.5)
    b1, b2, bq = randn(gen, h8, scale=0.1), randn(gen, c8, scale=0.1), randn(gen, 3 * c8,
                                                                            scale=0.1)
    return [
        ("standard_attention", ops.standard_attention, ops.standard_attention_reference,
         (qkv, heads)),
        ("octic_attention_fused_qkv", ops.octic_attention_fused_qkv,
         ops.octic_attention_fused_qkv_reference, (*xs, wq1, wqe, opt(bq), heads)),
        ("dense_gelu", ops.dense_gelu, ops.dense_gelu_reference, (x, w_fc1, opt(b_fc1))),
        ("mlp_d8_fused", ops.mlp_d8_fused, ops.mlp_d8_fused_reference,
         (xs, w1a, wea, opt(b1), w1b, web, opt(b2))),
    ]


def compare(out, ref):
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    err, ok = 0.0, True
    for o, r in zip(outs, refs, strict=True):
        if o.shape != r.shape or o.dtype != r.dtype:
            raise AssertionError(f"shape/dtype {o.shape} {o.dtype} vs {r.shape} {r.dtype}")
        d = (o.float() - r.float()).abs()
        err = max(err, d.max().item())
        ok &= bool((d <= ATOL + RTOL * r.float().abs()).all()) and bool(o.isfinite().all())
    return err, ok


META = {
    "standard_attention": ("octic_vits_tpu_torch/csrc/attention.cu",
                           "octic_vits_tpu/ops/pallas_attention.py:1234"),
    "octic_attention_fused_qkv": ("octic_vits_tpu_torch/csrc/attention.cu",
                                  "octic_vits_tpu/ops/pallas_attention.py:538"),
    "dense_gelu": ("octic_vits_tpu_torch/csrc/dense.cu", "octic_vits_tpu/ops/pallas_dense.py:111"),
    "mlp_d8_fused": ("octic_vits_tpu_torch/csrc/lin_d8.cu",
                     "octic_vits_tpu/ops/pallas_linear.py:550"),
}
EXTRA_SOURCES = {"octic_attention_fused_qkv": ["octic_vits_tpu_torch/csrc/lin_d8.cu"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    card = gpu_name_and_power()
    print(card, flush=True)
    phase("P0", f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
                f"| count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from octic_vits_tpu_torch import create_model, init_weights, ops
    from octic_vits_tpu_torch.kernels import build, library

    lib_path, seconds = build(verbose=True)
    library()
    phase("P1", f"build: {seconds:.2f} s -> {lib_path}")

    gen = torch.Generator("cuda").manual_seed(SEED)
    summary = {}
    failed = []
    for label, shape in (("vith14_b64", (BATCH, 257, 1280, 16, True)),
                         ("ragged", (3, 65, 64, 2, False))):
        with torch.no_grad():
            for name, kern, ref, args in kernel_cases(gen, *shape):
                out = kern(*args)
                torch.cuda.synchronize()
                expected = ref(*args)
                err, ok = compare(out, expected)
                entry = summary.setdefault(name, {"max_abs_err": 0.0})
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
                line = f"{name} [{label}] max_abs_err {err:.3e} (tol {ATOL}+{RTOL}*|ref|) "
                line += "ok" if ok else "FAIL"
                if label == "vith14_b64":
                    before = kern.launches
                    entry["ms"] = time_ms(lambda: kern(*args))
                    entry["plain_ms"] = time_ms(lambda: ref(*args), iters=10)
                    if kern.launches <= before:
                        raise AssertionError(f"{name}: launch counter did not move")
                    line += f" | kernel {entry['ms']:.4f} ms, plain {entry['plain_ms']:.4f} ms"
                phase("P2", line)
                if not ok:
                    failed.append(f"{name}[{label}]")
                del out, expected
    if failed:
        raise AssertionError(f"kernels outside tolerance: {failed}")

    # ---- P3: the slice, full-width hybrid ViT-H/14 ----
    torch.manual_seed(SEED)
    cpu_model = create_model("hybrid_deit_huge_patch14", init_scale=1.0).eval()
    init_weights(cpu_model, torch.Generator().manual_seed(SEED))
    model = create_model("hybrid_deit_huge_patch14", init_scale=1.0, device="cuda",
                         dtype=torch.bfloat16).eval()
    model.load_state_dict(cpu_model.state_dict(), strict=True)
    images = torch.randn(BATCH, IMG, IMG, 3, generator=torch.Generator().manual_seed(SEED + 1))
    images_gpu = images.to("cuda", torch.bfloat16)
    ops.reset_launch_counts()
    with torch.no_grad():
        logits = model(images_gpu)
    torch.cuda.synchronize()
    launches = {op.__name__: op.launches for op in ops.KERNEL_OPS}
    if tuple(logits.shape) != (BATCH, 1000) or not bool(logits.isfinite().all()):
        raise AssertionError(f"bad logits: shape {tuple(logits.shape)}")
    if any(v != 16 for v in launches.values()):
        raise AssertionError(f"expected 16 launches of each kernel, got {launches}")
    with torch.no_grad():
        ref = cpu_model(images[:2].to(torch.bfloat16).float())
    got = logits[:2].float().cpu()
    rel = ((got - ref).norm() / ref.norm()).item()
    phase("P3", f"hybrid_deit_huge_patch14 B={BATCH} bf16: logits {tuple(logits.shape)} finite, "
                f"launches {launches}; 2 images vs CPU f32 plain path: rel L2 err {rel:.3e} "
                f"(tol {SLICE_REL_TOL}), max abs err {(got - ref).abs().max().item():.3e}, "
                f"|ref| max {ref.abs().max().item():.3e}")
    if not rel <= SLICE_REL_TOL:
        raise AssertionError("hybrid logits disagree with the CPU f32 plain path")
    del cpu_model

    # ---- P4: timing, hybrid vs standard ----
    std = create_model("deit_huge_patch14_LS", device="cuda", dtype=torch.bfloat16).eval()
    init_weights(std, torch.Generator("cuda").manual_seed(SEED))
    with torch.no_grad():
        ms_h = time_ms(lambda: model(images_gpu), iters=10, warmup=2)
        ms_s = time_ms(lambda: std(images_gpu), iters=10, warmup=2)
        ms_h2 = time_ms(lambda: model(images_gpu), iters=10, warmup=1)
    ips_h, ips_s = BATCH / (min(ms_h, ms_h2) / 1e3), BATCH / (ms_s / 1e3)
    phase("P4", f"B={BATCH} 224^2 bf16 on {card}: hybrid {ips_h:.1f} img/s "
                f"({ms_h:.2f} / {ms_h2:.2f} ms), standard {ips_s:.1f} img/s ({ms_s:.2f} ms), "
                f"ratio hybrid/standard {ips_h / ips_s:.4f}")

    kernels = []
    for name, (source, replaces) in META.items():
        e = summary[name]
        item = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name], "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                "plain_ms": e["plain_ms"]}
        if name in EXTRA_SOURCES:
            item["also"] = EXTRA_SOURCES[name]
        kernels.append(item)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
