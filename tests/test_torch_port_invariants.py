"""Parity of the port's invariant family with the JAX package on the CPU, in
f32: the seven invariant kinds forward and backward (``jax.vjp`` against
autograd) with E given as ``[..., 2, C/4]`` and as a view of the flat-E
``[..., C/2]``, the learned kinds with and without ``global_avg``, orbit
products that tie; ``InvariantHead``; the tiny invariant-early model with
each kind, flat-E and packed, against JAX from the same parameters
(``params_from_jax``); and the invariance property of
tests/test_models.py:50-70 on the port. Inputs come from seeded numpy
generators. Tolerance 1e-5 unless a test says otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octic_vits_tpu.layers import invariants as JI
from octic_vits_tpu.models import OcticVisionTransformer as JOctic
from octic_vits_tpu_torch import init_weights
from octic_vits_tpu_torch.d8 import group as T
from octic_vits_tpu_torch.layers import invariants as TI
from octic_vits_tpu_torch.models import OcticVisionTransformer
from octic_vits_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)
ATOL = RTOL = 1e-5
C8 = 4
DIM = 8 * C8
LEARNED = ("max_filtering", "canonization")


def _close(ours, theirs, atol=ATOL, rtol=RTOL, msg=""):
    if isinstance(ours, torch.Tensor):
        ours = ours.detach().numpy()
    np.testing.assert_allclose(ours, np.asarray(theirs), atol=atol, rtol=rtol, err_msg=msg)


def _perturb(tree, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(np.shape(a))).astype(np.float32),
        tree)


def _inputs(seed, layout, lead, tied=False):
    """The four 1-d slots and E as arrays: E ``[*lead, 2, C/4]`` ("e2"), or
    the flat ``[*lead, C/2]`` that both sides view as ``[*lead, 2, C/4]``
    ("flat_e"). With `tied` only A1 is non-zero, so all 8 orbit products
    tie."""
    rng = np.random.default_rng(seed)
    ones = [rng.standard_normal(lead + (C8,)).astype(np.float32) for _ in range(4)]
    e = rng.standard_normal(lead + ((2, 2 * C8) if layout == "e2" else (4 * C8,)))
    e = e.astype(np.float32)
    if tied:
        ones[1:] = [np.zeros_like(ones[1])] * 3
        e = np.zeros_like(e)
    return ones + [e]


def _as5(leaves):
    """The 5-tuple of the leaves, a flat E viewed as ``[..., 2, C/4]``."""
    e = leaves[4]
    if e.ndim == leaves[0].ndim:
        e = e.reshape(tuple(e.shape[:-1]) + (2, 2 * C8))
    return tuple(leaves[:4]) + (e,)


def _kind_vjp(jmod, jparams, tmod, leaves, seed):
    """Forward and VJP of the flax module and the port's on the same input
    leaves (E viewed as [..., 2, C/4] on both sides): outputs, input
    gradients and parameter gradients."""
    def jf(p, *xs):
        return jmod.apply({"params": p} if p is not None else {}, _as5(xs))

    jp = jax.tree_util.tree_map(jnp.asarray, jparams) if jparams is not None else None
    jout, vjp = jax.vjp(jf, jp, *(jnp.asarray(x) for x in leaves))
    g = np.random.default_rng(seed).standard_normal(jout.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(g))
    if jparams is not None:
        tmod.load_state_dict(params_from_jax({"params": jparams}, tmod), strict=True)
    tleaves = [torch.from_numpy(x.copy()).requires_grad_() for x in leaves]
    tout = tmod(_as5(tleaves))
    tout.backward(torch.from_numpy(g))
    _close(tout, jout, msg="output")
    for i, (x, jg) in enumerate(zip(tleaves, jgrads[1:])):  # an unused input has none
        _close(torch.zeros_like(x) if x.grad is None else x.grad, jg, msg=f"input grad {i}")
    if jparams is not None:
        theirs = params_from_jax({"params": jax.device_get(jgrads[0])}, tmod)
        for name, p in tmod.named_parameters():  # argmax passes no gradient to a reference
            _close(torch.zeros_like(p) if p.grad is None else p.grad, theirs[name],
                   msg=f"grad {name}")
    return tout


# (kind, options): the learned kinds with and without global_avg, and a
# reference count of their own
KIND_CASES = [("power_spectrum", {}), ("non_invariant", {}), ("linear", {}),
              ("polynomial", {}), ("third_order", {}),
              ("max_filtering", {}), ("max_filtering", {"global_avg": True}),
              ("max_filtering", {"num_references": 12}),
              ("canonization", {}), ("canonization", {"global_avg": True})]


def _case_id(case):
    kind, opts = case
    return kind + "".join(f"-{k}={v}" for k, v in opts.items())


def _pair(kind, opts, leaves, seed):
    """The flax module, its perturbed parameters (None for a kind without
    any) and the port's module."""
    jmod = JI.INVARIANTS[kind](dim=DIM, **opts)
    jparams = None
    if kind in LEARNED:
        jparams = _perturb(jmod.init(jax.random.PRNGKey(seed), _as5(
            [jnp.asarray(x) for x in leaves]))["params"], seed)
    return jmod, jparams, TI.make_invariant(kind, DIM, **opts)


@pytest.mark.parametrize("layout", ["e2", "flat_e"])
@pytest.mark.parametrize("case", KIND_CASES, ids=_case_id)
def test_invariant_kind_matches_jax(case, layout):
    kind, opts = case
    lead = (3,) if opts.get("global_avg") else (2, 5)
    leaves = _inputs(1, layout, lead)
    jmod, jparams, tmod = _pair(kind, opts, leaves, 2)
    out = _kind_vjp(jmod, jparams, tmod, leaves, 3)
    assert out.shape[-1] == tmod.output_dim == jmod.output_dim


@pytest.mark.parametrize("kind", LEARNED)
def test_tied_orbit_products_match_jax(kind):
    """Only A1 is non-zero, so the 8 orbit products of every reference tie:
    max-filtering's gradient is shared among the tied maxima as JAX shares
    it (``torch.amax``), and canonization's argmax takes the first maximum,
    the identity, in both frameworks."""
    leaves = _inputs(4, "e2", (2, 5), tied=True)
    jmod, jparams, tmod = _pair(kind, {}, leaves, 5)
    out = _kind_vjp(jmod, jparams, tmod, leaves, 6)
    if kind == "canonization":  # the identity acted: the input itself
        _close(out, np.concatenate([leaves[0]] + [np.zeros_like(leaves[0])] * 7, -1), atol=0,
               rtol=0)


def test_make_invariant_and_table():
    assert set(TI.INVARIANTS) == set(JI.INVARIANTS)
    for kind in TI.INVARIANTS:
        mod = TI.make_invariant(kind, 64)
        assert mod.output_dim == JI.INVARIANTS[kind](dim=64).output_dim, kind
    assert TI.make_invariant("max_filtering", 64, num_references=7).output_dim == 7
    with pytest.raises(ValueError, match="invariant_kind"):
        TI.make_invariant("no_such_kind", 64)
    # the learned kinds draw normalised parameters from the caller's generator
    for kind, dims in (("max_filtering", (1, 2)), ("canonization", (0,))):
        a, b = (TI.make_invariant(kind, 64) for _ in range(2))
        init_weights(a, torch.Generator().manual_seed(0))
        init_weights(b, torch.Generator().manual_seed(0))
        p = next(a.parameters())
        assert torch.equal(p, next(b.parameters()))
        _close(torch.linalg.vector_norm(p, dim=dims), np.ones(p.norm(dim=dims).shape))


@pytest.mark.parametrize("use_norm,num_classes", [(False, 10), (True, 10), (True, 0)])
def test_invariant_head_matches_jax(use_norm, num_classes):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 48)).astype(np.float32)
    jhead = JI.InvariantHead(hidden_dim=24, num_classes=num_classes, use_norm=use_norm)
    params = _perturb(jhead.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 8)
    jout, vjp = jax.vjp(lambda p, a: jhead.apply({"params": p}, a),
                        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    g = rng.standard_normal(jout.shape).astype(np.float32)
    jgp, jgx = vjp(jnp.asarray(g))
    thead = TI.InvariantHead(48, 24, num_classes, use_norm)
    thead.load_state_dict(params_from_jax({"params": params}, thead), strict=True)
    tx = torch.from_numpy(x).requires_grad_()
    out = thead(tx)
    out.backward(torch.from_numpy(g))
    assert tuple(out.shape) == (3, num_classes or 24)
    _close(out, jout)
    _close(tx.grad, jgx)
    theirs = params_from_jax({"params": jax.device_get(jgp)}, thead)
    for name, p in thead.named_parameters():
        _close(p.grad, theirs[name], msg=name)


# ---- the tiny invariant-early model ---------------------------------------------------

# tests/test_models.py's invariant model
KW = dict(img_size=32, patch_size=8, embed_dim=64, depth=4, num_heads=2, mlp_ratio=2.0,
          qkv_bias=True, invariant=True, num_classes=10, init_scale=1.0)


def _random_params(jmodule, seed, *args):
    """Seeded parameters in the flax tree of `jmodule` (shapes from
    ``jax.eval_shape``): norm and LayerScale scales near 1, every other leaf
    small, none at a trivial value."""
    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(0), *args))
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        base = 1.0 if ("alpha" in name or name.endswith("scale")) else 0.0
        return (base + 0.1 * rng.standard_normal(sd.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes["params"])


def _images(seed=0, b=2):
    return np.random.default_rng(seed).standard_normal((b, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("kind", sorted(JI.INVARIANTS))
def test_small_inv_early_kind_logits_match_jax(kind):
    """Eval-mode logits of the port's tiny invariant-early model with each
    kind, flat-E and packed, against the JAX model's from the same
    perturbed parameters."""
    img = _images()
    jmodel = JOctic(**KW, invariant_kind=kind)
    params = _random_params(jmodel, 9, jnp.asarray(img))
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(img)))
    for packed in (False, True):
        tmodel = OcticVisionTransformer(**KW, invariant_kind=kind, packed_carry=packed,
                                        device="cpu")
        tmodel.load_state_dict(params_from_jax({"params": params}, tmodel), strict=True)
        with torch.no_grad():
            ours = tmodel.eval()(torch.from_numpy(img)).numpy()
        assert ours.shape == ref.shape == (2, 10)
        _close(ours, ref, msg=f"packed={packed}")


def _nhwc_action(g, img):
    return T.image_space_group_action(g, img.movedim(-1, 1)).movedim(1, -1)


@pytest.mark.parametrize("kind", sorted(set(JI.INVARIANTS) - {"non_invariant"}))
def test_inv_early_model_is_invariant(kind):
    """The port's invariant-early model gives the same logits for all 8
    transformed images (atol 1e-4, tests/test_models.py's bar), and other
    logits for a channel flip, which is not in D8 (the negative control)."""
    model = OcticVisionTransformer(**KW, invariant_kind=kind, device="cpu").eval()
    init_weights(model, torch.Generator().manual_seed(1))
    img = torch.from_numpy(_images(3))
    with torch.no_grad():
        base = model(img)
        assert base.abs().max() > 1e-4
        for g in T.GROUP_ELEMENTS[1:]:
            _close(model(_nhwc_action(g, img)), base.numpy(), atol=1e-4, rtol=0, msg=f"g={g}")
        assert (model(img.flip(-1)) - base).abs().max() > 1e-3


@pytest.mark.parametrize("kind", sorted(set(JI.INVARIANTS) - {"non_invariant"}))
def test_invariant_kind_is_invariant(kind):
    """Each invariant of the port gives the same features for the isotypic
    action of all 8 elements (tests/test_layers_equivariance.py's check);
    non_invariant does not (the negative control)."""
    rng = np.random.default_rng(11)
    xs8 = tuple(torch.from_numpy(rng.standard_normal((2, 3, 4)).astype(np.float32))
                for _ in range(8))
    mod = TI.make_invariant(kind, 32)
    init_weights(mod, torch.Generator().manual_seed(2))
    neg = TI.make_invariant("non_invariant", 32)
    with torch.no_grad():
        base = mod(T.pack_8_to_5(xs8))
        assert base.abs().max() > 1e-6
        diffs = []
        for g in T.GROUP_ELEMENTS:
            acted = T.pack_8_to_5(T.isotypic_group_action(g, xs8))
            _close(mod(acted), base.numpy(), msg=f"g={g}")
            diffs.append((neg(acted) - neg(T.pack_8_to_5(xs8))).abs().max())
    assert max(diffs) > 1e-3
