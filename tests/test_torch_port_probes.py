"""CPU parity of the attention probes (kernel row 14a,
``octic_vits_tpu_torch/ops/attention_probe.py``) against the Pallas kernels
of the four TPU scripts they port, run in interpret mode:
``scripts/profile_attn_kernel.py``, ``r3_attn_ablate.py``, ``r3_attn_bh.py``
and ``r3_attn_headmajor.py``. One case per row a-p and dtype.

The scripts are loaded read-only with importlib. Each sets the JAX
compilation-cache directory when it is imported; the loader restores the
setting it found. Their module globals B and N (and DT for f32) are set per
test with monkeypatch. Rows k and l rebuild the ``pallas_call`` spec of
``r3_attn_ablate.py:main``'s ``mk_pad`` (:235, :258), which lives inside
``main()``.

Shapes: B=2, N=19 (ragged), H=16, C=1280: the scripts' published widths, so
their hard-coded d1 = 10, de = 20 and aligned columns up to 128*2 + 80 stay
in range. Only the columns the JAX kernel writes are compared.

Tolerances: f32 |port - jax| <= 1e-5 + 1e-5 |jax|. bf16 the bars of
``chip_smoke.py``: forward 1e-2 + 2e-2 |jax|, backward 2e-2 (max|jax| + |jax|).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from octic_vits_tpu_torch import ops
from octic_vits_tpu_torch.probes.profile_attn_kernel import interleave_wide
from octic_vits_tpu_torch.probes.r3_attn_bh import pad_qkv
from octic_vits_tpu_torch.probes.r3_attn_headmajor import from_headmajor, to_headmajor

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
B, N, H, C = 2, 19, 16, 1280
C8, DH, DHP = C // 8, C // H, 128
F32_TOL = 1e-5
ATOL, RTOL, BWD_TOL = 1e-2, 2e-2, 2e-2  # chip_smoke.py's forward and backward bars


@pytest.fixture(scope="module")
def scripts():
    """The four scripts as modules, the JAX cache setting restored after
    each import."""
    mods = {}
    for name in ("profile_attn_kernel", "r3_attn_ablate", "r3_attn_bh", "r3_attn_headmajor"):
        saved = (jax.config.jax_compilation_cache_dir,
                 jax.config.jax_persistent_cache_min_compile_time_secs)
        spec = importlib.util.spec_from_file_location(f"_probe_script_{name}",
                                                      SCRIPTS / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        try:
            spec.loader.exec_module(mod)
        finally:
            jax.config.update("jax_compilation_cache_dir", saved[0])
            jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])
        mods[name] = mod
    return mods


@pytest.fixture
def setup(scripts, monkeypatch, request):
    """Set B, N (and DT) in every script for this test's dtype."""
    dtype = request.param
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    for mod in scripts.values():
        monkeypatch.setattr(mod, "B", B)
        monkeypatch.setattr(mod, "N", N)
        if hasattr(mod, "DT"):
            monkeypatch.setattr(mod, "DT", jdt)
    return scripts, dtype, jdt


def _inputs(dtype, seed, *shapes):
    """The same random inputs for both sides: (jax arrays, torch tensors)."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s, dtype=np.float32) for s in shapes]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return [jnp.asarray(x).astype(jdt) for x in xs], [torch.from_numpy(x).to(tdt) for x in xs]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype, backward=False, cols=None):
    gots = got if isinstance(got, (tuple, list)) else (got,)
    wants = want if isinstance(want, (tuple, list)) else (want,)
    assert len(gots) == len(wants)
    for i, (g, w) in enumerate(zip(gots, wants)):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape, (i, g.shape, w.shape)
        if cols is not None:
            g, w = g[..., cols], w[..., cols]
        if dtype == "float32":
            bar = F32_TOL + F32_TOL * np.abs(w)
        elif backward:
            bar = BWD_TOL * (np.abs(w).max() + np.abs(w))
        else:
            bar = ATOL + RTOL * np.abs(w)
        err = np.abs(g - w)
        assert np.all(err <= bar), f"output {i}: max err {err.max():.3e}"


def _octic_shapes(jdt):
    return tuple(jax.ShapeDtypeStruct((B, N, C8 if i < 4 else 2 * C8), jdt) for i in range(6))


def _arrs(dtype):
    return _inputs(dtype, 1, *[(B, N, 3 * C8)] * 4, *[(B, N, 6 * C8)] * 2)


def _row_a(mods, dtype, jdt):
    pak = mods["profile_attn_kernel"]
    ja, ta = _arrs(dtype)
    want = pak._call_synth(pak._aligned_loads_kernel, _octic_shapes(jdt), ja)
    _close(ops.aligned_loads_attention(*ta, H), want, dtype)


def _aligned_row(kernel_of, op):
    def run(mods, dtype, jdt):
        pak = mods["profile_attn_kernel"]
        ja, ta = _arrs(dtype)
        shapes = (jax.ShapeDtypeStruct((B, N, DHP * H), jdt),)
        (want,) = pak._call_synth(kernel_of(pak), shapes, ja)
        written = (np.arange(DHP * H) % DHP) < DH
        _close(op(*ta, H), want, dtype, cols=written)
    return run


def _row_e(mods, dtype, jdt):
    pak = mods["profile_attn_kernel"]
    ja, ta = _arrs(dtype)
    wide_j = pak._interleave_wide(ja)
    wide_t = interleave_wide(tuple(ta), H)
    np.testing.assert_array_equal(_np(wide_t), _np(wide_j))
    want = pak._call_synth(pak._wide_in_kernel, _octic_shapes(jdt), (wide_j,))
    _close(ops.octic_attention_wide(wide_t, H), want, dtype)


def _std_row(kernel_name, op, scratch=False, **kw):
    def run(mods, dtype, jdt):
        ab = mods["r3_attn_ablate"]
        (jq,), (tq,) = _inputs(dtype, 2, (B, N, 3 * C))
        want = ab._call_std(getattr(ab, kernel_name), jq, scratch)
        _close(op(tq, H, **kw), want, dtype)
    return run


def _padded(mods, dtype):
    """The padded qkv on both sides (the script's pad_qkv and the port's)."""
    (jq,), (tq,) = _inputs(dtype, 3, (B, N, 3 * C))
    jp, tp = mods["r3_attn_bh"].pad_qkv(jq), pad_qkv(tq, H, DHP)
    np.testing.assert_array_equal(_np(tp), _np(jp))
    return jp, tp


def _mk_pad_call(kernel, jdt, octic):
    """r3_attn_ablate.py:main's mk_pad spec (:235, :258)."""
    spec_in = [pl.BlockSpec((1, N, 3 * H * DHP), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)]
    if octic:
        shapes = _octic_shapes(jdt)
        out_specs = tuple(pl.BlockSpec((1,) + s.shape[1:], lambda i: (i, 0, 0),
                                       memory_space=pltpu.VMEM) for s in shapes)
    else:
        shapes = jax.ShapeDtypeStruct((B, N, H * DHP), jdt)
        out_specs = pl.BlockSpec((1, N, H * DHP), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)
    return pl.pallas_call(kernel, grid=(B,), in_specs=spec_in, out_specs=out_specs,
                          out_shape=shapes, interpret=True)


def _row_k(mods, dtype, jdt):
    ab = mods["r3_attn_ablate"]
    jp, tp = _padded(mods, dtype)
    _close(ops.padded_attention(tp, H, DH), _mk_pad_call(ab.k_padded_full, jdt, False)(jp),
           dtype)
    _close(ops.padded_attention(tp, H, DH, "scores"),
           _mk_pad_call(ab.k_padded_scores, jdt, False)(jp), dtype)


def _row_l(mods, dtype, jdt):
    ab = mods["r3_attn_ablate"]
    jp, tp = _padded(mods, dtype)
    _close(ops.padded_octic_attention(tp, H, DH),
           _mk_pad_call(ab.k_padded_octic_store, jdt, True)(jp), dtype)


def _row_m(mods, dtype, jdt):
    jp, tp = _padded(mods, dtype)
    _close(ops.bh_std_attention(tp, H, DH), mods["r3_attn_bh"].call_std_bh(jp), dtype)


def _row_n(mods, dtype, jdt):
    jp, tp = _padded(mods, dtype)
    _close(ops.bh_octic_attention(tp, H, DH), mods["r3_attn_bh"].call_octic_bh(jp), dtype)


def _row_o(mods, dtype, jdt):
    hm = mods["r3_attn_headmajor"]
    (jq,), (tq,) = _inputs(dtype, 4, (B, N, 3 * C))
    jhm, thm = hm.to_headmajor(jq), to_headmajor(tq, H)
    np.testing.assert_array_equal(_np(thm), _np(jhm))
    want = hm.headmajor_attention(jhm, H)
    got = ops.headmajor_attention(thm, H)
    _close(got, want, dtype)
    np.testing.assert_array_equal(_np(from_headmajor(got)), _np(hm.from_headmajor(_np(got))))


def _row_p(mods, dtype, jdt):
    hm = mods["r3_attn_headmajor"]
    (jq, jg), (tq, tg) = _inputs(dtype, 5, (B, N, 3 * C), (B, H, N, DH))
    want = hm.headmajor_attention_bwd(hm.to_headmajor(jq), jg, H)
    _close(ops.headmajor_attention_bwd(to_headmajor(tq, H), tg, H), want, dtype, backward=True)


ROWS = {
    "a": _row_a,
    "b": _aligned_row(lambda m: m._aligned_all_kernel, ops.aligned_all_attention),
    "c": _aligned_row(lambda m: m._aligned_all_variant(m._attn_head_nosm),
                      ops.aligned_nosm_attention),
    "d": _aligned_row(lambda m: m._aligned_all_variant(m._attn_head_cheapsm),
                      ops.aligned_cheap_attention),
    "e": _row_e,
    "f": _std_row("k_scores_only", ops.scores_only_attention),
    "g": _std_row("k_scores_softmax", ops.scores_softmax_attention),
    "h": _std_row("k_full", ops.full_attention),
    "i": _std_row("k_interleave2", ops.interleave2_attention),
    "j": _std_row("k_phased", ops.phased_attention, scratch=True),
    "k": _row_k,
    "l": _row_l,
    "m": _row_m,
    "n": _row_n,
    "o": _row_o,
    "p": _row_p,
}


@pytest.mark.parametrize("setup", ["float32", "bfloat16"], indirect=True)
@pytest.mark.parametrize("row", sorted(ROWS))
def test_probe_matches_script_kernel(setup, row):
    mods, dtype, jdt = setup
    ROWS[row](mods, dtype, jdt)


def test_loads_stage_is_v():
    """Probe f's "loads" stage (the floor of the H100 split) writes v."""
    qkv = torch.randn(B, N, 3 * C, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(ops.scores_only_attention(qkv, H, "loads").numpy(),
                                  qkv[..., 2 * C:].numpy())


def test_probes_count_no_cpu_launch():
    """The plain versions run on CPU tensors, and no launch is counted."""
    before = {op.__name__: op.launches for op in ops.PROBE_OPS}
    qkv = torch.randn(1, 5, 3 * C)
    ops.full_attention(qkv, H)
    ops.interleave2_attention(qkv, H)
    assert {op.__name__: op.launches for op in ops.PROBE_OPS} == before
