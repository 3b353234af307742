"""Parity of the port's octic fused-glue ops and paths with the JAX package
on the CPU, in f32: the D8 LayerNorm (with and without the affine), the
D8-GELU, the LayerScale + residual epilogue of the D8 linear and the fused
MLP branch, each forward and VJP against its JAX function (the Pallas
kernels in interpret mode, as the JAX package's own tests run them); then
BlockD8 and the small hybrid model in the three configurations that run
them (``fuse_mlp_branch``, ``fuse_block_epilogues``, and plain linears with
the D8-GELU kernel in a DeiT III train step), with ``OCTIC_PALLAS_LN`` on
both sides; and the entry points' device default. Inputs come from seeded
numpy generators and go to both sides. Tolerance 1e-5 unless a test says
otherwise: f32 on both sides, sums in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octic_vits_tpu.layers import d8_layers as jd8
from octic_vits_tpu.models.registry import create_model as j_create_model
from octic_vits_tpu.ops.pallas_gelu import gelu_d8_pallas as j_gelu_d8
from octic_vits_tpu.ops.pallas_linear import linear_d8_tuple as j_linear_d8_tuple
from octic_vits_tpu.ops.pallas_ln import (
    ln_affine_d8_flat_tuple as j_ln_affine,
    ln_d8_flat_tuple as j_ln,
)
from octic_vits_tpu.ops.pallas_mlp_branch import mlp_branch_d8 as j_mlp_branch
from octic_vits_tpu.train.common import create_train_state as j_create_state
from octic_vits_tpu.train.deit import engine as jengine
from octic_vits_tpu_torch import create_model, ops
from octic_vits_tpu_torch.layers import d8_layers as td8
from octic_vits_tpu_torch.train import common
from octic_vits_tpu_torch.train.deit import engine
from octic_vits_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)
ATOL = RTOL = 1e-5


def _n(rng, *shape, scale=1.0, shift=0.0):
    return (shift + scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _close(ours, theirs, atol=ATOL, rtol=RTOL, msg=""):
    if isinstance(ours, torch.Tensor):
        ours = ours.detach().numpy()
    theirs = np.asarray(theirs)
    np.testing.assert_allclose(ours, theirs.reshape(ours.shape), atol=atol, rtol=rtol,
                               err_msg=msg)


def _tuple5(rng, lead, c, shift=0.0):
    """A flat-E 5-tuple with nonzero means, so that the mean removal counts."""
    return [_n(rng, *lead, c, shift=shift) for _ in range(4)] + [_n(rng, *lead, 4 * c,
                                                                    shift=-shift)]


def _vjp_both(jfn, jargs, tfn, targs, gs):
    """Forward and VJP of the JAX function and the port's on the same inputs
    (a pytree of arrays each); returns (JAX out, JAX grads, port out, port
    grads), the grads in the order of the leaves."""
    jout, vjp = jax.vjp(jfn, *jax.tree_util.tree_map(jnp.asarray, jargs))
    jgrads = jax.tree_util.tree_leaves(vjp(jax.tree_util.tree_map(jnp.asarray, gs)))
    leaves = [_t(a, grad=True) for a in jax.tree_util.tree_leaves(targs)]
    tree = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(targs), leaves)
    tout = tfn(*tree)
    torch.autograd.backward(tout, [_t(g) for g in jax.tree_util.tree_leaves(gs)])
    return jout, jgrads, tout, [t.grad for t in leaves]


# ---- the ops ------------------------------------------------------------------

# (lead shape, c): M = 22 and 21 tokens are not a multiple of any row tile
LN_SHAPES = [((2, 11), 8), ((3, 7), 16)]


@pytest.mark.parametrize("lead,c", LN_SHAPES)
def test_ln_affine_d8_matches_jax(lead, c):
    rng = np.random.default_rng(20)
    xs = _tuple5(rng, lead, c, shift=0.5)
    al, ae, be = _n(rng, 4, c, shift=1.0, scale=0.2), _n(rng, 1, 4 * c, shift=1.0, scale=0.2), \
        _n(rng, 1, c, scale=0.2)
    gs = _tuple5(rng, lead, c)
    jout, jg, tout, tg = _vjp_both(
        lambda x, a, e, b: j_ln_affine(x, a, e, b, 1e-5), (tuple(xs), al, ae, be),
        lambda x, a, e, b: ops.ln_affine_d8_flat_tuple(tuple(x), a, e, b, 1e-5),
        (list(xs), al, ae, be), tuple(gs))
    for i in range(5):
        _close(tout[i], jout[i], msg=f"out {i}")
    # dx (5), dalpha, dalpha_ef, dbeta; the parameter gradients sum over the
    # tokens, hence the absolute bar scaled by M
    for i, (o, t) in enumerate(zip(tg, jg)):
        _close(o, t, atol=ATOL * (1 if i < 5 else 30), msg=f"grad {i}")


@pytest.mark.parametrize("lead,c", LN_SHAPES)
def test_ln_d8_matches_jax(lead, c):
    rng = np.random.default_rng(21)
    xs = _tuple5(rng, lead, c, shift=-0.3)
    gs = _tuple5(rng, lead, c)
    jout, jg, tout, tg = _vjp_both(lambda x: j_ln(x, 1e-5), (tuple(xs),),
                                   lambda x: ops.ln_d8_flat_tuple(tuple(x), 1e-5),
                                   (list(xs),), tuple(gs))
    for i in range(5):
        _close(tout[i], jout[i], msg=f"out {i}")
        _close(tg[i], jg[i], msg=f"grad {i}")


def test_ln_ops_hold_their_residuals():
    """The affine op saves its inputs and recomputes the statistics; the
    statistics-only op saves its normalized output and the per-token var
    (pallas_ln.py:380-382, :406-409)."""
    rng = np.random.default_rng(22)
    xs = [_t(a, grad=True) for a in _tuple5(rng, (2, 5), 8)]
    al, ae, be = (_t(np.ones(s, np.float32), grad=True) for s in ((4, 8), (1, 32), (1, 8)))
    out = ops.ln_affine_d8_flat_tuple(tuple(xs), al, ae, be)
    saved = out[0].grad_fn.saved_tensors
    assert len(saved) == 7 and all(any(s is x for s in saved) for x in xs)
    out = ops.ln_d8_flat_tuple(tuple(xs))
    saved = out[0].grad_fn.saved_tensors
    assert tuple(saved[0].shape) == (10, 1) and saved[0].dtype == torch.float32
    assert [tuple(s.shape) for s in saved[1:]] == [tuple(x.shape) for x in xs]


@pytest.mark.parametrize("flat_e", [True, False])
def test_gelu_d8_matches_jax(flat_e):
    rng = np.random.default_rng(23)
    b, n, c = 2, 7, 16
    xs = [_n(rng, b, n, c) for _ in range(4)]
    xs.append(_n(rng, b, n, 4 * c) if flat_e else _n(rng, b, n, 2, 2 * c))
    gs = [_n(rng, *x.shape) for x in xs]
    # the JAX f32 kernel's erf is A&S 7.1.26 (max abs error 1.5e-7); the port's is exact
    jout, jg, tout, tg = _vjp_both(lambda x: j_gelu_d8(x), (tuple(xs),),
                                   lambda x: ops.gelu_d8(tuple(x)), (list(xs),), tuple(gs))
    for i in range(5):
        _close(tout[i], jout[i], msg=f"out {i}")
        _close(tg[i], jg[i], msg=f"grad {i}")
    # it saves only the input (pallas_gelu.py:225-227)
    out = ops.gelu_d8(tuple(_t(x, grad=True) for x in xs))
    assert [tuple(t.shape) for t in out[0].grad_fn.saved_tensors] == [x.shape for x in xs]


@pytest.mark.parametrize("bias", [True, False])
def test_linear_d8_epilogue_matches_jax(bias):
    rng = np.random.default_rng(24)
    b, n, c, f = 2, 5, 8, 16
    xs = _tuple5(rng, (b, n), c)
    w1, we = _n(rng, 4, c, f, scale=0.3), _n(rng, 2 * c, 2 * f, scale=0.3)
    bb = _n(rng, f) if bias else None
    ls1, lse = _n(rng, 4, f, shift=0.5), _n(rng, 2 * f, shift=0.5)
    res = _tuple5(rng, (b, n), f)
    gs = _tuple5(rng, (b, n), f)

    def jfn(x, w1_, we_, ls1_, lse_, r, *bb_):
        return j_linear_d8_tuple(x, w1_, we_, bb_[0] if bb_ else None, layerscale=(ls1_, lse_),
                                 residual=r, flat_e=True, interpret=True)

    def tfn(x, w1_, we_, ls1_, lse_, r, *bb_):
        return ops.linear_d8_tuple(tuple(x), w1_, we_, bb_[0] if bb_ else None,
                                   layerscale=(ls1_, lse_), residual=tuple(r))

    args = (xs, w1, we, ls1, lse, res) + ((bb,) if bias else ())
    jout, jg, tout, tg = _vjp_both(jfn, tuple(tuple(a) if isinstance(a, list) else a
                                              for a in args), tfn, args, tuple(gs))
    for i in range(5):
        _close(tout[i], jout[i], msg=f"out {i}")
    names = [f"dx{i}" for i in range(5)] + ["dw1", "dwe", "dls1", "dlse"] + [
        f"dr{i}" for i in range(5)] + (["dbias"] if bias else [])
    for name, o, t in zip(names, tg, jg, strict=True):
        _close(o, t, msg=name)
    with pytest.raises(ValueError):
        ops.linear_d8_fused(tuple(map(_t, xs)), _t(w1), _t(we), None, True,
                            (_t(ls1), _t(lse)), tuple(map(_t, res)))


def _branch_case(rng, lead, c, h):
    xs = _tuple5(rng, lead, c)
    params = (_n(rng, 4, c, shift=1.0, scale=0.1), _n(rng, 2 * c, shift=1.0, scale=0.1),
              _n(rng, c, scale=0.1), _n(rng, 4, c, h, scale=0.3), _n(rng, 2 * c, 2 * h, scale=0.3),
              _n(rng, h, scale=0.1), _n(rng, 4, h, c, scale=0.3), _n(rng, 2 * h, 2 * c, scale=0.3),
              _n(rng, c, scale=0.1), _n(rng, 4, c, shift=1.0, scale=0.1),
              _n(rng, 2 * c, shift=1.0, scale=0.1))
    return xs, params


def test_mlp_branch_d8_matches_jax():
    """Forward and VJP (the JAX rule differentiates its eager composite,
    which takes E as [..., 2, 2c]; the port's flat-E E is its reshape)."""
    rng = np.random.default_rng(25)
    b, n, c, h = 2, 5, 8, 16
    xs, params = _branch_case(rng, (b, n), c, h)
    gs = _tuple5(rng, (b, n), c)
    jxs = tuple(xs[:4]) + (xs[4].reshape(b, n, 2, 2 * c),)
    jgs = tuple(gs[:4]) + (gs[4].reshape(b, n, 2, 2 * c),)
    jout, vjp = jax.vjp(lambda x, p: j_mlp_branch(x, p, 1e-5),
                        *jax.tree_util.tree_map(jnp.asarray, (jxs, params)))
    jgx, jgp = vjp(jax.tree_util.tree_map(jnp.asarray, jgs))
    txs = [_t(a, grad=True) for a in xs]
    tps = [_t(a, grad=True) for a in params]
    tout = ops.mlp_branch_d8(tuple(txs), tuple(tps), 1e-5)
    torch.autograd.backward(tout, [_t(g) for g in gs])
    for i in range(5):
        _close(tout[i], jout[i], msg=f"out {i}")
        _close(txs[i].grad, jgx[i], msg=f"dx {i}")
    for i in range(11):
        # parameter gradients sum over the tokens
        _close(tps[i].grad, jgp[i], atol=1e-4, msg=f"dparam {i}")
    # the plain composite (the backward's rule) agrees with the op's plain version
    eager = ops.mlp_branch_eager(tuple(map(_t, xs)), tuple(map(_t, params)))
    for o, t in zip(eager, tout):
        _close(o, t.detach())


# ---- BlockD8 in the three configurations ---------------------------------------

B, N, C, HEADS = 1, 11, 64, 2
BENCH = dict(use_pallas_attention=True, use_pallas_linear=True, fuse_qkv=True, fuse_mlp=True)
# JAX block flags, port block flags, train mode
BLOCK_CASES = {
    "A_fused_branch": (dict(BENCH, fuse_mlp_branch=True), dict(fuse_mlp_branch=True), False),
    "B_epilogues": (dict(BENCH, fuse_block_epilogues=True), dict(fuse_block_epilogues=True), False),
    "C_plain_linear_gelu_kernel": (dict(use_pallas_attention=True, use_pallas_linear=False,
                                        use_pallas_gelu=True),
                                   dict(use_pallas_linear=False, use_pallas_gelu=True), True),
}


def _random_params(jmodule, seed, *args, **kwargs):
    """Seeded parameters in the flax tree of `jmodule` (its shapes from
    ``jax.eval_shape``: an interpret-mode init would run every Pallas kernel
    once more): LayerNorm and LayerScale scales near 1, every other leaf
    small, none at a trivial value."""
    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        base = 1.0 if ("alpha" in name or name.endswith("scale")) else 0.0
        return (base + 0.1 * rng.standard_normal(sd.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes["params"])


@pytest.fixture
def pallas_ln(monkeypatch):
    """OCTIC_PALLAS_LN on in both packages for one test."""
    monkeypatch.setattr(jd8, "OCTIC_PALLAS_LN", True)
    monkeypatch.setattr(td8, "OCTIC_PALLAS_LN", True)


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_block_d8_matches_jax(case, pallas_ln, monkeypatch):
    jflags, tflags, train = BLOCK_CASES[case]
    rng = np.random.default_rng(26)
    xs = tuple(_tuple5(rng, (B, N), C // 8))
    jblk = jd8.BlockD8(num_heads=HEADS, mlp_ratio=2.0, qkv_bias=True, layerscale_init=1.0,
                       **jflags)
    jin = tuple(map(jnp.asarray, xs))
    params = _random_params(jblk, 0, jin)
    tblk = td8.BlockD8(C, HEADS, mlp_ratio=2.0, qkv_bias=True, layerscale_init=1.0, **tflags)
    tblk.load_state_dict(params_from_jax({"params": params}, tblk), strict=True)
    tblk.train(train)
    calls = []
    for name in ("ln_affine_d8_flat_tuple", "mlp_branch_d8", "gelu_d8", "linear_d8_fused"):
        fn = getattr(td8, name)
        monkeypatch.setattr(td8, name, lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or
                            _fn(*a, **k))
    jfwd = lambda p, x: jblk.apply({"params": p}, x, deterministic=not train)  # noqa: E731
    txs = [_t(a, grad=True) for a in xs]
    tout = tblk(tuple(txs))
    expected = {"A_fused_branch": {"ln_affine_d8_flat_tuple", "mlp_branch_d8"},
                "B_epilogues": {"ln_affine_d8_flat_tuple", "linear_d8_fused"},
                "C_plain_linear_gelu_kernel": {"ln_affine_d8_flat_tuple", "gelu_d8"}}[case]
    assert set(calls) == expected
    if case == "A_fused_branch":
        # inference only: the JAX rule of mlp_branch_d8 cannot differentiate a
        # flat-E tuple (pallas_mlp_branch.py:159-164 multiplies the [..., 4c]
        # E by the [2c] alpha_e); test_mlp_branch_d8_matches_jax holds the
        # port's backward with the [..., 2, 2c] layout
        jout = jfwd(params, jin)
        for i in range(5):
            _close(tout[i], jout[i], msg=f"out {i}")
        return
    gs = tuple(_tuple5(rng, (B, N), C // 8))
    jout, vjp = jax.vjp(jfwd, jax.tree_util.tree_map(jnp.asarray, params), jin)
    jgp, jgx = vjp(tuple(map(jnp.asarray, gs)))
    for i in range(5):
        _close(tout[i], jout[i], msg=f"out {i}")
    torch.autograd.backward(tout, [_t(g) for g in gs])
    for i in range(5):
        _close(txs[i].grad, jgx[i], msg=f"dx {i}")
    ours = {n: p.grad for n, p in tblk.named_parameters()}
    theirs = params_from_jax({"params": jax.device_get(jgp)}, tblk)
    for name, g in ours.items():
        # parameter gradients sum over the B*N tokens
        _close(g, theirs[name], atol=1e-4, msg=name)


def test_block_fused_paths_follow_jax_conditions():
    """The epilogue comes first and needs use_pallas_linear and no drop path
    in training; the MLP branch only where the epilogue is off."""
    both = td8.BlockD8(C, HEADS, fuse_block_epilogues=True, fuse_mlp_branch=True, drop_path=0.1)
    assert both.eval().fuse_epilogue() and not both.fuse_branch()
    assert not both.train().fuse_epilogue() and not both.fuse_branch()
    branch = td8.BlockD8(C, HEADS, fuse_mlp_branch=True)
    assert branch.train().fuse_branch() and not branch.fuse_epilogue()
    plain = td8.BlockD8(C, HEADS, fuse_block_epilogues=True, fuse_mlp_branch=True,
                        use_pallas_linear=False)
    assert not plain.eval().fuse_epilogue() and not plain.fuse_branch()


# ---- the slice's paths on the small hybrid -----------------------------------------

MODEL_BENCH = dict(BENCH, use_pallas_std_mlp=True, flat_e_carry=True)


@pytest.mark.parametrize("path", ["A_fused_branch", "B_epilogues"])
def test_small_hybrid_logits_match_jax(path, pallas_ln):
    extra = dict(fuse_mlp_branch=True) if path == "A_fused_branch" else dict(
        fuse_block_epilogues=True)
    img = np.random.default_rng(27).standard_normal((2, 16, 16, 3)).astype(np.float32)
    jmodel = j_create_model("hybrid_vit_small_test", img_size=16, **MODEL_BENCH, **extra)
    params = _random_params(jmodel, 1, jnp.asarray(img))
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(img)))
    tmodel = create_model("hybrid_vit_small_test", img_size=16, device="cpu", **extra)
    tmodel.load_state_dict(params_from_jax({"params": params}, tmodel), strict=True)
    ops.reset_launch_counts()
    with torch.no_grad():
        ours = tmodel.eval()(_t(img)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-4)  # the bar of test_torch_port_model.py


def test_small_hybrid_deit_step_matches_jax(pallas_ln):
    """One DeiT III step of hybrid_vit_small_test with the train flags
    (scan, remat) but plain linears and the D8-GELU kernel, the JAX A/B
    variant flat_xoctmlp (scripts/r3_model_ab.py:38-39), from shared
    parameters: loss, gradient norm and every updated parameter."""
    img_size = 16
    flags = dict(use_pallas_attention=True, use_pallas_linear=False, use_pallas_gelu=True,
                 use_pallas_std_mlp=True, flat_e_carry=True)
    jmodel = j_create_model("hybrid_vit_small_test", img_size=img_size, drop_path_rate=0.0,
                            **flags)
    params = _random_params(jmodel, 3, jnp.zeros((1, img_size, img_size, 3)))
    rng = np.random.default_rng(4)
    images = _n(rng, 4, img_size, img_size, 3)
    labels = rng.integers(0, 10, size=4).astype(np.int32)
    cfg = dict(num_classes=10, mixup_alpha=0.0, cutmix_alpha=0.0, drop_path=0.0,
               warmup_epochs=0, epochs=10, steps_per_epoch=10, lr=1e-3)
    jcfg = jengine.DeiTConfig(**cfg)
    tx = jengine.build_optimizer(jcfg, params)
    jstate = j_create_state(jax.tree_util.tree_map(jnp.asarray, params), tx, ema=True)
    jstep = jax.jit(jengine.make_deit_train_step(jmodel, jcfg, tx))
    jstate, jmetrics = jstep(jstate, jnp.asarray(images), jnp.asarray(labels),
                             jax.random.PRNGKey(0))

    tmodel = create_model("hybrid_vit_small_test", img_size=img_size, remat=True,
                          use_pallas_linear=False, use_pallas_gelu=True, device="cpu")
    tmodel.load_state_dict(params_from_jax({"params": params}, tmodel), strict=True)
    tcfg = engine.DeiTConfig(**cfg)
    opt = engine.build_optimizer(tcfg, tmodel)
    state = common.create_train_state(tmodel, opt, ema=True)
    step = engine.make_deit_train_step(tmodel, tcfg, opt)
    state, metrics = step(state, _t(images), _t(labels).long(), torch.Generator().manual_seed(0))
    _close(metrics["loss"], jmetrics["loss"], msg="loss")
    _close(metrics["grad_norm"], jmetrics["grad_norm"], msg="grad norm")
    new = params_from_jax({"params": jax.device_get(jstate.params)}, tmodel)
    for name, p in tmodel.named_parameters():
        _close(p, new[name], msg=name)


# ---- the entry points' device --------------------------------------------------


def test_entry_points_default_to_the_card():
    """create_model and SSLMetaArch build on CUDA when no device is named;
    on a machine without a card that raises instead of running on the CPU."""
    from octic_vits_tpu_torch.train.dinov2.ssl_meta_arch import SSLConfig, SSLMetaArch

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_model("hybrid_vit_small_test")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SSLMetaArch(SSLConfig(arch="hybrid_dinov2_vit_tiny_test"))
    model = create_model("hybrid_vit_small_test", device="cpu")
    assert next(model.parameters()).device.type == "cpu"
