"""CPU parity of the probes of kernel row 14b against the Pallas kernels of
the three TPU scripts they port, run in interpret mode:

* ``scripts/r3_attn_experiments.py`` (``octic_vits_tpu_torch/ops/
  attention_probe.py``): the cls-split keys, two images a grid step and the
  hoisted octic assembly, on the standard and the octic layouts;
* ``scripts/profile_lin_tiles.py`` (``ops/linear_probe.py``): the qkv
  LinearD8 with the tuple store and the wide store at two token tiles;
* ``scripts/r3_matmul_law.py`` (``ops/mma_probe.py``): the twelve product
  shapes of its ``main``.

The scripts are loaded read-only with importlib; each sets the JAX
compilation-cache directory when it is imported, and the loader restores the
setting it found. Their module globals B and N (and M, DT, and the cls-split
block NKM = N - 1, which the JAX cls-split needs) are set with monkeypatch.
The call sites inside ``main()`` (``r3_attn_experiments.py`` :279, :303 and
all of ``r3_matmul_law.py``) run through ``main()`` itself: its
``measure_steps`` is replaced by a stub that runs each timed closure once on
numpy-seeded inputs of the same shapes, and the module's ``pl`` by a
namespace whose ``pallas_call`` runs in interpret mode and records each
call's kernel, inputs and outputs (``r3_attn_experiments.py:main`` calls the
JAX package's ``octic_attention`` and ``standard_attention`` with
``interpret=False``; the test hands it versions that interpret, as it does
its own calls). ``profile_lin_tiles.py:call_wide`` passes
four inputs to its five ``in_specs`` (the zero bias it builds is never
passed) and fails as written on every backend, so the wide case rebuilds its
``pallas_call`` with that bias; ``call_tuple`` runs as it stands.

Shapes: H=16, C=1280 (the scripts' published widths, so their hard-coded
d1 = 10, de = 20 stay in range), B=2 and N=19 (ragged); the tiles 8 and 16
leave a ragged last block of M = 38 tokens.

Tolerances: f32 |port - jax| <= 1e-5 + 1e-5 |jax|. bf16 the forward bar of
``chip_smoke.py``, 1e-2 + 2e-2 |jax|, and for the product law its law bar,
1e-6 + 1e-4 |jax| (both sides sum exact bf16 products in f32).
"""

import functools
import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from octic_vits_tpu_torch import ops
from octic_vits_tpu_torch.ops.attention_probe import ALIGN

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
B, N, H, C = 2, 19, 16, 1280
C8, DH = C // 8, C // H
F = 3 * C8
F32_TOL = 1e-5
ATOL, RTOL = 1e-2, 2e-2  # chip_smoke.py's forward bar
LAW_ATOL, LAW_RTOL = 1e-6, 1e-4  # and its product-law bar (exact bf16 products, f32 sums)
DTYPES = ["float32", "bfloat16"]


def _load(name):
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    spec = importlib.util.spec_from_file_location(f"_probe_script_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", saved[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])
    return mod


@pytest.fixture(scope="module")
def scripts():
    return {name: _load(name)
            for name in ("r3_attn_experiments", "profile_lin_tiles", "r3_matmul_law")}


def _jdt(dtype):
    return jnp.float32 if dtype == "float32" else jnp.bfloat16


def _tdt(dtype):
    return torch.float32 if dtype == "float32" else torch.bfloat16


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x, dtype):
    """A JAX array as a torch tensor of the same values."""
    return torch.from_numpy(np.array(_np(x))).to(_tdt(dtype))


def _close(got, want, dtype, bf16_tol=(ATOL, RTOL)):
    gots = got if isinstance(got, (tuple, list)) else (got,)
    wants = want if isinstance(want, (tuple, list)) else (want,)
    assert len(gots) == len(wants)
    for i, (g, w) in enumerate(zip(gots, wants)):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape, (i, g.shape, w.shape)
        tol = (F32_TOL, F32_TOL) if dtype == "float32" else bf16_tol
        err = np.abs(g - w)
        assert np.all(err <= tol[0] + tol[1] * np.abs(w)), f"output {i}: max err {err.max():.3e}"


class _RecordingPallas(types.SimpleNamespace):
    """A stand-in for a script's ``pl``: ``pallas_call`` in interpret mode,
    each call's (kernel, inputs, outputs) appended to `calls`; every other
    name is ``pl``'s."""

    def __init__(self, calls):
        super().__init__(calls=calls)

    def __getattr__(self, name):
        return getattr(pl, name)

    def pallas_call(self, kernel, **kw):
        kw["interpret"] = True
        call = pl.pallas_call(kernel, **kw)

        def run(*args):
            out = call(*args)
            self.calls.append((kernel, args, out))
            return out
        return run


def _run_main(mod, dtype, seed, scale, **patch):
    """Run a script's main() at B, N (and `patch`) in `dtype`, each timed
    closure once on numpy-seeded inputs; returns the recorded pallas_calls."""
    calls = []
    rng = np.random.default_rng(seed)

    def measure_steps(fn, params, x, **_):
        fresh = tuple(jnp.asarray(rng.standard_normal(p.shape, dtype=np.float32) * scale)
                      .astype(p.dtype) for p in params)
        jax.block_until_ready(fn(fresh, x))
        return 1.0

    with pytest.MonkeyPatch.context() as mp:
        for k, v in dict(B=B, N=N, DT=_jdt(dtype), pl=_RecordingPallas(calls),
                         measure_steps=measure_steps, **patch).items():
            mp.setattr(mod, k, v)
        mod.main()
    return calls


def _kernel_name(kernel):
    if isinstance(kernel, functools.partial):
        return kernel.func.__name__, dict(kernel.keywords)
    return kernel.__name__, {}


# ---------------------------------------------------------------------------
# scripts/r3_attn_experiments.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def experiments(scripts):
    """main()'s recorded calls per dtype: the numerics check's octic split,
    then std nb=2, octic nb=2, std cls-split, octic cls-split, hoist,
    hoist+split (the current kernels are the JAX package's, not recorded)."""
    mod = scripts["r3_attn_experiments"]
    # main() calls the JAX package's kernels with interpret=False
    interp = {k: (lambda f: lambda *a: f(*a[:-1], True))(getattr(mod, k))
              for k in ("octic_attention", "standard_attention")}
    return {dt: _run_main(mod, dt, 7, 1.0, NKM=N - 1, **interp) for dt in DTYPES}


# the recorded call -> the port's op and its keyword arguments
EXPERIMENT_CASES = {
    "std_nb2": (("_std_multib_kernel", {"nb": 2}), ops.multi_image_attention, {}),
    "octic_nb2": (("_octic_multib_kernel", {"nb": 2}), ops.multi_image_octic_attention, {}),
    "std_split": (("_std_split_kernel", {}), ops.cls_split_attention, {}),
    "octic_split": (("_octic_split_kernel", {}), ops.cls_split_octic_attention, {}),
    "hoist": (("_octic_hoist_kernel", {"split": False}), ops.hoist_octic_attention, {}),
    "hoist_split": (("_octic_hoist_kernel", {"split": True}), ops.hoist_octic_attention,
                    {"split": True}),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(EXPERIMENT_CASES))
def test_experiment_matches_script_kernel(experiments, dtype, case):
    key, op, kw = EXPERIMENT_CASES[case]
    calls = [c for c in experiments[dtype] if _kernel_name(c[0]) == key]
    # main() runs _octic_split_kernel twice (its numerics check, then timed)
    assert len(calls) == (2 if case == "octic_split" else 1)
    for _, args, want in calls:
        got = op(*[_t(a, dtype) for a in args], H, **kw)
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_hoist_assembly_is_the_scripts_scratch(scripts, dtype):
    """Phase 1 of _octic_hoist_kernel: slot (s, h) of the padded qkv holds
    concat(_octic_slices(refs, h, ..., s)), then zeros (exactly)."""
    mod = scripts["r3_attn_experiments"]
    rng = np.random.default_rng(3)
    arrs = [rng.standard_normal((B, N, 3 * C8 if i < 4 else 6 * C8), dtype=np.float32)
            for i in range(6)]
    jarrs = [jnp.asarray(a).astype(_jdt(dtype)) for a in arrs]
    got = _np(ops.hoist_assembly(*[_t(a, dtype) for a in jarrs], H)).reshape(B, N, 3, H, ALIGN)
    for b in range(B):
        refs = tuple(a[b:b + 1] for a in jarrs)
        for s in range(3):
            for h in range(H):
                want = _np(jnp.concatenate(mod._octic_slices(refs, h, H, mod.D1, mod.DE, s),
                                           axis=1))
                np.testing.assert_array_equal(got[b, :, s, h, :DH], want)
    assert not got[..., DH:].any()


def test_experiment_ops_check_their_shapes():
    """Two images a CTA need an even batch and the cls-split two tokens, as
    the JAX grid (B // nb) and split need; both raise on the CPU too."""
    qkv = torch.randn(3, 5, 3 * C)
    with pytest.raises(ValueError, match="even batch"):
        ops.multi_image_attention(qkv, H)
    arrs = [torch.randn(3, 5, 3 * C8 if i < 4 else 6 * C8) for i in range(6)]
    with pytest.raises(ValueError, match="even batch"):
        ops.multi_image_octic_attention(*arrs, H)
    with pytest.raises(ValueError, match="N >= 2"):
        ops.cls_split_attention(torch.randn(2, 1, 3 * C), H)
    with pytest.raises(ValueError, match="N >= 2"):
        ops.hoist_octic_attention(*[a[:2, :1] for a in arrs], H, split=True)


def test_cls_split_is_attention():
    """The cls-split is the same function as the attention (exact f32)."""
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.standard_normal((2, N, 3 * C)).astype(np.float32))
    torch.testing.assert_close(ops.cls_split_attention(qkv, H), ops.full_attention(qkv, H),
                               atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# scripts/profile_lin_tiles.py
# ---------------------------------------------------------------------------


@pytest.fixture
def lin_tiles(scripts, monkeypatch, request):
    dtype = request.param
    mod = scripts["profile_lin_tiles"]
    for k, v in dict(B=B, N=N, M=B * N, DT=_jdt(dtype), pl=_RecordingPallas([])).items():
        monkeypatch.setattr(mod, k, v)
    rng = np.random.default_rng(11)
    shapes = ((4, B * N, C8), (B * N, 4 * C8), (4, C8, F), (2 * C8, 2 * F))
    scales = (0.2, 0.2, 0.05, 0.05)  # profile_lin_tiles.py:main's
    xs = [jnp.asarray(rng.standard_normal(s, dtype=np.float32) * k).astype(_jdt(dtype))
          for s, k in zip(shapes, scales)]
    return mod, dtype, xs


def _call_wide_with_bias(mod, x1, xef, w1, we, tm):
    """profile_lin_tiles.py:call_wide's pallas_call (:62-79) with the zero
    bias its in_specs name passed."""
    m = mod.M
    kern = functools.partial(mod.PL._wide_kernel, num_heads=mod.H, use_bias=False)
    spec = functools.partial(pl.BlockSpec, memory_space=pltpu.VMEM)
    return pl.pallas_call(
        kern, grid=(pl.cdiv(m, tm),),
        in_specs=[spec((4, tm, C8), lambda i: (0, i, 0)), spec((tm, 4 * C8), lambda i: (i, 0)),
                  spec((4, C8, F), lambda i: (0, 0, 0)), spec((2 * C8, 2 * F), lambda i: (0, 0)),
                  spec((1, F), lambda i: (0, 0))],
        out_specs=spec((tm, 8 * F), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((m, 8 * F), mod.DT), interpret=True,
    )(x1, xef, w1, we, jnp.zeros((1, F), mod.DT))


@pytest.mark.parametrize("lin_tiles", DTYPES, indirect=True)
@pytest.mark.parametrize("tm", [8, 16])
@pytest.mark.parametrize("store", ["tuple", "wide"])
def test_lin_tiles_match_script_kernel(lin_tiles, tm, store):
    mod, dtype, xs = lin_tiles
    if store == "tuple":
        want = mod.call_tuple(*xs, tm)
    else:
        want = _call_wide_with_bias(mod, *xs, tm)
    # the port's tile does not change its result; every tile's reference is the same
    for bm, bn in ops.linear_probe.TILES:
        got = ops.lin_d8_tiled(*[_t(x, dtype) for x in xs], bm=bm, bn=bn, store=store,
                               num_heads=H)
        _close(got, want, dtype)


def test_lin_tiled_rejects_unbuilt_tile():
    x1, xef = torch.randn(4, 6, 16), torch.randn(6, 64)
    w1, we = torch.randn(4, 16, 24), torch.randn(32, 48)
    with pytest.raises(ValueError, match="not built"):
        ops.lin_d8_tiled(x1, xef, w1, we, bm=128, bn=64, store="tuple")
    with pytest.raises(ValueError, match="num_heads"):
        ops.lin_d8_tiled(x1, xef, w1, we, bm=64, bn=32, store="wide")


# ---------------------------------------------------------------------------
# scripts/r3_matmul_law.py
# ---------------------------------------------------------------------------

# main()'s twelve products in order: ten of bench_mm, two of bench_batched
LAW_CASES = ["scores_nt_80", "av_nn_80", "av_nn_256", "av_nn_384", "av_nn_512", "nn_k257_128",
             "nn_k128_128", "nn_k512_128", "nt_128", "nn_square_512", "batched_scores_nt",
             "batched_av_nn"]


@pytest.fixture(scope="module")
def law_calls(scripts):
    return {dt: _run_main(scripts["r3_matmul_law"], dt, 13, 0.02) for dt in DTYPES}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", range(len(LAW_CASES)), ids=LAW_CASES)
def test_matmul_law_matches_script_kernel(law_calls, dtype, case):
    calls = law_calls[dtype]
    assert len(calls) == len(LAW_CASES)
    kernel, (a, b), want = calls[case]
    name, kw = _kernel_name(kernel)
    ta, tb = _t(a, dtype), _t(b, dtype)
    if name == "_mm_kernel":
        got = ops.matmul_law(ta, tb, kw["mode"], kw["reps"])
    else:
        assert name == "batched_kernel" and a.ndim == 4
        got = ops.matmul_law_batched(ta, tb, kw["mode"])
    _close(got, want, dtype, (LAW_ATOL, LAW_RTOL))


def test_probes_14b_count_no_cpu_launch():
    """The plain versions run on CPU tensors, and no launch is counted."""
    before = {op.__name__: op.launches for op in ops.PROBE_OPS_14B}
    ops.cls_split_attention(torch.randn(2, 5, 3 * C), H)
    ops.matmul_law(torch.randn(1, 5, 8), torch.randn(1, 7, 8), "nt", 2)
    assert {op.__name__: op.launches for op in ops.PROBE_OPS_14B} == before
