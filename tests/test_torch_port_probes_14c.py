"""CPU parity of the probes of kernel row 14c (``octic_vits_tpu_torch/ops/
attention_bwd_probe.py``) against the Pallas kernels of
``scripts/r3_attn_bwd_ablate.py`` they port, run in interpret mode: the
wide-store and wide-g octic backwards, the standard pack forward and backward
(P = 2, 4), the standard and octic masked head pairs and quads, forward and
backward, and the fused qkv + attention with and without the proj. The
script's four other sites (the per-head standard forward and backward and the
default octic kernels) are held against the ops the port already has.

The script is loaded read-only with importlib; it sets the JAX compilation
cache directory when it is imported, and the loader restores the setting it
found. Its module globals B, H, N, C, C8, DH, D1, DE, SCALE and DT are set
consistently with monkeypatch (its ``octic_args`` captures B when it is
defined, so the inputs are built here from a numpy seed).

Shapes: H=8, C=320, N=45, B=2 for every site (d1 = 5, de = 10, dh = 40: N
ragged and N >= dh, which the script's pack backward needs); H=16, C=1280,
N=81 (d1 = 10, de = 20, dh = 80) for the octic pair and quad kernels and both
fused kernels. Tolerances: f32 |port - jax| <= 1e-5 + 1e-5 |jax|; bf16 the
forward bar of ``chip_smoke.py``, 1e-2 + 2e-2 |jax|, and its backward bar,
2e-2 (max|jax| + |jax|).

The tests at the end pin three facts about the script: its pack backward
fails whenever N < dh and the port's does not; every group op rejects a head
count its group does not divide; and the pack ops reproduce the shared row
max of the script's pack kernels.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octic_vits_tpu_torch import ops

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "r3_attn_bwd_ablate.py"
SMALL = (2, 45, 8, 320)   # B, N, H, C
WIDE = (2, 81, 16, 1280)
F32_TOL = 1e-5
ATOL, RTOL = 1e-2, 2e-2  # chip_smoke.py's forward bar
BWD_TOL = 2e-2           # and its backward bar, against max|jax| + |jax|
DTYPES = ["float32", "bfloat16"]


@pytest.fixture(scope="module")
def script():
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    spec = importlib.util.spec_from_file_location("_probe_script_r3_attn_bwd_ablate", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", saved[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])
    assert mod.INTERP
    return mod


def _jdt(dtype):
    return jnp.float32 if dtype == "float32" else jnp.bfloat16


def _tdt(dtype):
    return torch.float32 if dtype == "float32" else torch.bfloat16


def _set(monkeypatch, mod, shape, dtype):
    b, n, h, c = shape
    c8 = c // 8
    for name, val in dict(B=b, N=n, H=h, C=c, C8=c8, DH=c // h, D1=c8 // h, DE=2 * c8 // h,
                          SCALE=(c // h) ** -0.5, DT=_jdt(dtype)).items():
        monkeypatch.setattr(mod, name, val)


class Inputs:
    """numpy-seeded arrays, each handed to both sides (JAX and torch)."""

    def __init__(self, seed, dtype):
        self.rng = np.random.default_rng(seed)
        self.dtype = dtype

    def __call__(self, *shape, scale=1.0):
        x = (self.rng.standard_normal(shape) * scale).astype(np.float32)
        j = jnp.asarray(x).astype(_jdt(self.dtype))
        return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(_tdt(self.dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype, bwd=False):
    gots = got if isinstance(got, (tuple, list)) else (got,)
    wants = want if isinstance(want, (tuple, list)) else (want,)
    assert len(gots) == len(wants)
    for i, (g, w) in enumerate(zip(gots, wants)):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape, (i, g.shape, w.shape)
        assert np.all(np.isfinite(g)), f"output {i} not finite"
        err = np.abs(g - w)
        if dtype == "float32":
            bar = F32_TOL + F32_TOL * np.abs(w)
        elif bwd:
            bar = BWD_TOL * (np.abs(w).max() + np.abs(w))
        else:
            bar = ATOL + RTOL * np.abs(w)
        assert np.all(err <= bar), f"output {i}: max err {err.max():.3e}"


def _octic(mk, b, n, c8, scale=1.0):
    """The six octic qkv arrays and the six output cotangents (JAX, torch)."""
    ins = [mk(b, n, 3 * c8, scale=scale) for _ in range(4)] + [
        mk(b, n, 6 * c8, scale=scale) for _ in range(2)]
    gs = [mk(b, n, c8) for _ in range(4)] + [mk(b, n, 2 * c8) for _ in range(2)]
    return [j for j, _ in ins], [t for _, t in ins], [j for j, _ in gs], [t for _, t in gs]


# ---------------------------------------------------------------------------
# the wide-store and wide-g octic backwards (:795, :812)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_widestore_bwd_matches_script(script, monkeypatch, dtype):
    _set(monkeypatch, script, SMALL, dtype)
    b, n, h, c = SMALL
    jins, tins, jgs, tgs = _octic(Inputs(0, dtype), b, n, c // 8)
    want = script.call_octic_bwd_widestore(jins, jgs)
    _close(ops.octic_attention_bwd_widestore(tuple(tins), tuple(tgs), h), want, dtype, bwd=True)


@pytest.mark.parametrize("dtype", DTYPES)
def test_wideg_bwd_matches_script(script, monkeypatch, dtype):
    _set(monkeypatch, script, SMALL, dtype)
    b, n, h, c = SMALL
    mk = Inputs(1, dtype)
    jins, tins, _, _ = _octic(mk, b, n, c // 8)
    jgw, tgw = mk(b, n, c)
    want = script.call_octic_bwd_wideg(jins, jgw)
    _close(ops.octic_attention_bwd_wideg(tuple(tins), tgw, h), want, dtype, bwd=True)


# ---------------------------------------------------------------------------
# the standard layout: pack (:839, :865) and masked pairs (:883, :895)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("group", [2, 4])
def test_pack_fwd_matches_script(script, monkeypatch, dtype, group):
    _set(monkeypatch, script, SMALL, dtype)
    b, n, h, c = SMALL
    jq, tq = Inputs(2, dtype)(b, n, 3 * c)
    _close(ops.std_pack_attention(tq, h, group), script.call_std_pack_fwd(jq, group), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("group", [2, 4])
def test_pack_bwd_matches_script(script, monkeypatch, dtype, group):
    _set(monkeypatch, script, SMALL, dtype)
    b, n, h, c = SMALL
    mk = Inputs(3, dtype)
    (jq, tq), (jg, tg) = mk(b, n, 3 * c), mk(b, n, c)
    _close(ops.std_pack_attention_bwd(tq, tg, h, group), script.call_std_pack_bwd(jq, jg, group),
           dtype, bwd=True)


@pytest.mark.parametrize("dtype", DTYPES)
def test_maskpair_std_matches_script(script, monkeypatch, dtype):
    _set(monkeypatch, script, SMALL, dtype)
    b, n, h, c = SMALL
    mk = Inputs(4, dtype)
    (jq, tq), (jg, tg) = mk(b, n, 3 * c), mk(b, n, c)
    _close(ops.std_maskpair_attention(tq, h), script.call_std_maskpair_fwd(jq), dtype)
    _close(ops.std_maskpair_attention_bwd(tq, tg, h), script.call_std_maskpair_bwd(jq, jg),
           dtype, bwd=True)


# ---------------------------------------------------------------------------
# the octic layout: masked pairs and quads (:926, :779), both widths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [SMALL, WIDE], ids=["h8", "h16"])
@pytest.mark.parametrize("group", [2, 4])
def test_octic_group_fwd_matches_script(script, monkeypatch, dtype, shape, group):
    _set(monkeypatch, script, shape, dtype)
    b, n, h, c = shape
    jins, tins, _, _ = _octic(Inputs(5, dtype), b, n, c // 8)
    kernel = script.k_octic_maskpair_fwd if group == 2 else script.k_octic_maskquad_fwd
    want = script.call_octic_fwd(jins, kernel=kernel)
    _close(ops.octic_group_attention(*tins, h, group), want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [SMALL, WIDE], ids=["h8", "h16"])
@pytest.mark.parametrize("group", [2, 4])
def test_octic_group_bwd_matches_script(script, monkeypatch, dtype, shape, group):
    _set(monkeypatch, script, shape, dtype)
    b, n, h, c = shape
    jins, tins, jgs, tgs = _octic(Inputs(6, dtype), b, n, c // 8)
    if group == 2:
        want = script.call_octic_maskpair_bwd(jins, jgs)
    else:
        want = script.call_octic_bwd(jins, jgs, kernel=script.k_octic_maskquad_bwd)
    _close(ops.octic_group_attention_bwd(tuple(tins), tuple(tgs), h, group), want, dtype,
           bwd=True)


# ---------------------------------------------------------------------------
# the fused qkv + attention (:735) and + proj (:693), both widths
# ---------------------------------------------------------------------------


def _fused_args(mk, b, n, c8):
    """The script's --fuseqkv-only inputs: x at 0.1, weights and biases at
    0.05 (JAX with the (1, w) biases it takes, torch with [w])."""
    xs = [mk(b, n, c8, scale=0.1) for _ in range(4)] + [mk(b, n, 4 * c8, scale=0.1)]
    w1, we, bias = mk(4, c8, 3 * c8, scale=0.05), mk(2 * c8, 6 * c8, scale=0.05), mk(
        1, 3 * c8, scale=0.05)
    w1p, wep, biasp = mk(4, c8, c8, scale=0.05), mk(2 * c8, 2 * c8, scale=0.05), mk(
        1, c8, scale=0.05)
    jax_args = [j for j, _ in xs] + [w1[0], we[0], bias[0]]
    torch_args = [t for _, t in xs] + [w1[1], we[1], bias[1][0]]
    proj = ([w1p[0], wep[0], biasp[0]], [w1p[1], wep[1], biasp[1][0]])
    return jax_args, torch_args, proj


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [SMALL, WIDE], ids=["h8", "h16"])
def test_fused_qkv_attention_matches_script(script, monkeypatch, dtype, shape):
    _set(monkeypatch, script, shape, dtype)
    b, n, h, c = shape
    jargs, targs, (jproj, tproj) = _fused_args(Inputs(7, dtype), b, n, c // 8)
    _close(ops.octic_qkv_attention(*targs, h), script.call_octic_qkvattn_fwd(*jargs), dtype)
    _close(ops.octic_qkv_attention_proj(*targs, *tproj, h),
           script.call_octic_qkvattnproj_fwd(*jargs, *jproj), dtype)


def test_fused_qkv_attention_without_bias_matches_composition():
    """bias None: the same as the op with zero biases."""
    mk = Inputs(8, "float32")
    b, n, h, c = SMALL
    _, targs, (_, tproj) = _fused_args(mk, b, n, c // 8)
    zero = [torch.zeros_like(targs[7]), torch.zeros_like(tproj[2])]
    got = ops.octic_qkv_attention_proj(*targs[:7], None, *tproj[:2], None, h)
    want = ops.octic_qkv_attention_proj(*targs[:7], zero[0], *tproj[:2], zero[1], h)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# the script's sites whose kernels the port already has (:853, :823, :926, :779)
# ---------------------------------------------------------------------------


def test_script_default_kernels_are_the_shipped_ops(script, monkeypatch):
    dtype = "float32"
    _set(monkeypatch, script, SMALL, dtype)
    b, n, h, c = SMALL
    mk = Inputs(9, dtype)
    (jq, tq), (jg, tg) = mk(b, n, 3 * c), mk(b, n, c)
    _close(ops.standard_attention_reference(tq, h), script.call_std_fwd_loop(jq), dtype)
    _close(ops.standard_attention_bwd_reference(tq, tg, h), script.call_std_bwd(jq, jg), dtype)
    jins, tins, jgs, tgs = _octic(mk, b, n, c // 8)
    _close(ops.octic_attention_reference(*tins, h), script.call_octic_fwd(jins), dtype)
    _close(ops.octic_attention_bwd_reference(tuple(tins), tuple(tgs), h),
           script.call_octic_bwd(jins, jgs), dtype)


# ---------------------------------------------------------------------------
# three facts about the script
# ---------------------------------------------------------------------------


def test_pack_bwd_at_n_below_head_dim(script, monkeypatch):
    """At N = 33 < dh = 40 the script's pack backward raises (it cuts each
    head's normaliser to dh columns of an [N, N] broadcast); the port's
    matches the script's per-head backward."""
    dtype, shape = "float32", (2, 33, 8, 320)
    _set(monkeypatch, script, shape, dtype)
    b, n, h, c = shape
    mk = Inputs(10, dtype)
    (jq, tq), (jg, tg) = mk(b, n, 3 * c), mk(b, n, c)
    with pytest.raises(TypeError):
        script.call_std_pack_bwd(jq, jg, 2)
    want = script.call_std_bwd(jq, jg)
    for group in (2, 4):
        _close(ops.std_pack_attention_bwd(tq, tg, h, group), want, dtype)


def test_group_ops_reject_heads_their_group_does_not_divide():
    """H = 6 with groups of 4, and odd H (3) with pairs: the script's loops
    leave the last head unwritten or read past the heads; the port raises."""
    for h, group in ((6, 4), (3, 2)):
        dh = 40
        c = h * dh
        c8 = c // 8
        qkv, g = torch.randn(1, 9, 3 * c), torch.randn(1, 9, c)
        qs = tuple(torch.randn(1, 9, 3 * c8 if i < 4 else 6 * c8) for i in range(6))
        gs = tuple(torch.randn(1, 9, c8 if i < 4 else 2 * c8) for i in range(6))
        calls = [lambda: ops.std_pack_attention(qkv, h, group),
                 lambda: ops.std_pack_attention_bwd(qkv, g, h, group),
                 lambda: ops.octic_group_attention(*qs, h, group),
                 lambda: ops.octic_group_attention_bwd(qs, gs, h, group)]
        if group == 2:
            xs = tuple(torch.randn(1, 9, c8) for _ in range(4)) + (torch.randn(1, 9, 4 * c8),)
            w1, we = torch.randn(4, c8, 3 * c8), torch.randn(2 * c8, 6 * c8)
            calls += [lambda: ops.std_maskpair_attention(qkv, h),
                      lambda: ops.std_maskpair_attention_bwd(qkv, g, h),
                      lambda: ops.octic_qkv_attention(*xs, w1, we, None, h),
                      lambda: ops.octic_qkv_attention_proj(
                          *xs, w1, we, None, torch.randn(4, c8, c8), torch.randn(2 * c8, 2 * c8),
                          None, h)]
        for call in calls:
            with pytest.raises(ValueError):
                call()


@pytest.mark.parametrize("group", [2, 4])
def test_pack_reproduces_the_shared_max(script, monkeypatch, group):
    """bf16, the heads' q scaled 1x and 4x in turn: each row's shared max is
    the larger head's, far above the smaller head's own, so the bf16
    probabilities of the smaller head are rounded at a coarser step than with
    its own max. The pack op matches the script's pack kernel; the per-head
    shift (the masked pair's) lies outside the bar there."""
    dtype = "bfloat16"
    _set(monkeypatch, script, SMALL, dtype)
    b, n, h, c = SMALL
    dh = c // h
    mk = Inputs(11, dtype)
    x = mk.rng.standard_normal((b, n, 3 * c)).astype(np.float32)
    scale = np.ones(3 * c, np.float32)
    scale[:c] = np.repeat(np.where(np.arange(h) % 2 == 0, 4.0, 1.0), dh) * 2.0
    jq = jnp.asarray(x * scale).astype(jnp.bfloat16)
    tq = torch.from_numpy(np.asarray(jq.astype(jnp.float32))).to(torch.bfloat16)
    want = script.call_std_pack_fwd(jq, group)
    got = ops.std_pack_attention(tq, h, group)
    _close(got, want, dtype)
    own = ops.attention_bwd_probe._attn(*ops.attention_probe._std_heads(tq, h))
    own = ops.attention_probe._merge(own, torch.bfloat16)
    err = np.abs(_np(own) - _np(want))
    assert not np.all(err <= ATOL + RTOL * np.abs(_np(want))), "the shared max made no difference"


def test_probes_run_on_no_model_path():
    before = {op.__name__: op.launches for op in ops.PROBE_OPS_14C}
    qkv = torch.randn(1, 9, 3 * 320)
    ops.std_pack_attention(qkv, 8, 4)
    assert {op.__name__: op.launches for op in ops.PROBE_OPS_14C} == before
    assert all(op in ops.KERNEL_OPS and callable(op.reference) for op in ops.PROBE_OPS_14C)
