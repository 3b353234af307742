"""Parity of the port's evaluation slice with the JAX package on the CPU:
``get_intermediate_layers`` of both DINOv2 backbones, the metrics, k-NN, the
linear-probe grid, the attention-pool grid and segmentation probing. Inputs
come from seeded numpy generators and go to both sides; models share
weights through ``params_from_jax``, and the attention-pool banks start from
JAX's own ``_bank_init``. f32 unless a test says otherwise; tolerances per
test (1e-5 where both sides compute the same f32 function in another
order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octic_vits_tpu.eval import attnpool as J_ap
from octic_vits_tpu.eval import knn as J_knn
from octic_vits_tpu.eval import linear as J_lin
from octic_vits_tpu.eval import metrics as J_met
from octic_vits_tpu.eval import segmentation as J_seg
from octic_vits_tpu.models import DinoVisionTransformer as JDino
from octic_vits_tpu.models import OcticDinoVisionTransformer as JOcticDino
from octic_vits_tpu_torch import eval as T_eval
from octic_vits_tpu_torch.eval import attnpool as T_ap
from octic_vits_tpu_torch.eval import knn as T_knn
from octic_vits_tpu_torch.eval import linear as T_lin
from octic_vits_tpu_torch.eval import metrics as T_met
from octic_vits_tpu_torch.eval import segmentation as T_seg
from octic_vits_tpu_torch.models import DinoVisionTransformer, OcticDinoVisionTransformer
from octic_vits_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)
TOL = 1e-5


def _close(ours, theirs, tol=TOL, msg=""):
    np.testing.assert_allclose(T_met.to_numpy(ours), np.asarray(theirs), atol=tol, rtol=tol,
                               err_msg=msg)


def _perturb(tree, seed, scale=0.02):
    """Noise on every leaf, so that no LayerScale (init 1e-5) or norm affine
    sits at a value that hides its path."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(a.shape).astype(np.float32), tree)


# ---- get_intermediate_layers --------------------------------------------------

# depth 4, so that two blocks lie past the break (registry.py's tiny test
# backbone has one)
OCTIC_CFG = dict(img_size=32, patch_size=8, embed_dim=32, depth=4, num_heads=2, mlp_ratio=2.0,
                 init_scale=1e-5)
STD_CFG = dict(img_size=32, patch_size=8, embed_dim=32, depth=3, num_heads=2, mlp_ratio=2.0,
               layerscale_init=1e-5)


@pytest.fixture(scope="module")
def dino_pair():
    """{kind: (flax model, its perturbed parameters, the port model with them)}."""
    out = {}
    for kind, jcls, tcls, cfg, seed in (("octic", JOcticDino, OcticDinoVisionTransformer,
                                         OCTIC_CFG, 61),
                                        ("standard", JDino, DinoVisionTransformer, STD_CFG, 62)):
        jmodel = jcls(**cfg)
        params = _perturb(jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3)))[
            "params"], seed)
        tmodel = tcls(**cfg).eval()
        tmodel.load_state_dict(params_from_jax({"params": params}, tmodel), strict=True)
        out[kind] = (jmodel, params, tmodel)
    return out


GIL_CASES = [  # (kind, n, reshape, return_class_token, norm)
    ("octic", 2, False, True, True), ("octic", [2, 3], True, False, True),
    ("octic", [3], False, True, False), ("octic", 1, True, True, False),
    ("standard", 1, False, True, True), ("standard", 3, True, True, True),
    ("standard", [0, 2], False, False, False), ("standard", [1], True, False, True),
]


@pytest.mark.parametrize("kind,n,reshape,cls_token,norm", GIL_CASES)
def test_get_intermediate_layers_matches_jax(dino_pair, kind, n, reshape, cls_token, norm):
    jmodel, params, tmodel = dino_pair[kind]
    img = np.random.default_rng(70).standard_normal((2, 32, 32, 3)).astype(np.float32)
    theirs = jmodel.apply({"params": params}, jnp.asarray(img), n, reshape, cls_token, norm,
                          method=jmodel.get_intermediate_layers)
    with torch.no_grad():
        ours = tmodel.get_intermediate_layers(torch.from_numpy(img), n, reshape=reshape,
                                              return_class_token=cls_token, norm=norm)
    assert len(ours) == len(theirs) == (n if isinstance(n, int) else len(n))
    for o, t in zip(ours, theirs):
        pairs = zip(o, t) if cls_token else [(o, t)]
        for a, b in pairs:
            assert tuple(a.shape) == tuple(b.shape)
            _close(a, b)


def test_get_intermediate_layers_last_cls_is_forward_cls(dino_pair):
    for kind in ("octic", "standard"):
        tmodel = dino_pair[kind][2]
        x = torch.from_numpy(np.random.default_rng(71).standard_normal((2, 32, 32, 3))
                             .astype(np.float32))
        with torch.no_grad():
            (_, cls), = tmodel.get_intermediate_layers(x, 1, return_class_token=True)
            ref = tmodel.forward_features(x)["x_norm_clstoken"]
        assert torch.equal(cls, ref), kind


@pytest.mark.parametrize("n", [3, [1, 3], [0]])
def test_get_intermediate_layers_break_check(dino_pair, n):
    """Blocks before the equivariance break (2 of 4) cannot be taken: JAX
    asserts, the port raises ValueError."""
    jmodel, params, tmodel = dino_pair["octic"]
    x = np.zeros((1, 32, 32, 3), np.float32)
    with pytest.raises(AssertionError):
        jmodel.apply({"params": params}, jnp.asarray(x), n,
                     method=jmodel.get_intermediate_layers)
    with pytest.raises(ValueError, match="equivariance break"):
        tmodel.get_intermediate_layers(torch.from_numpy(x), n)


def test_with_intermediate_layers_and_normalize(dino_pair):
    _, _, tmodel = dino_pair["octic"]
    tmodel.train()
    x = torch.from_numpy(np.random.default_rng(72).standard_normal((2, 32, 32, 3))
                         .astype(np.float32))
    outs = T_eval.with_intermediate_layers(tmodel, n=2)(x)
    assert not tmodel.training and not outs[0][0].requires_grad
    with torch.no_grad():
        ref = tmodel.get_intermediate_layers(x, 2, return_class_token=True)
    for (p, c), (rp, rc) in zip(outs, ref):
        assert torch.equal(p, rp) and torch.equal(c, rc)
    f = np.random.default_rng(73).standard_normal((5, 7)).astype(np.float32)
    f[0] = 0.0  # a zero row: x / (0 + 1e-12) = 0, where F.normalize would differ in kind
    ours = T_eval.with_normalize(lambda a: torch.from_numpy(a))(f)
    theirs = np.asarray(J_knn.l2_normalize(jnp.asarray(f)))
    _close(ours, theirs)


# ---- metrics --------------------------------------------------------------------


def test_metrics_match_jax_exactly():
    rng = np.random.default_rng(80)
    logits = rng.standard_normal((50, 12)).astype(np.float32)
    labels = rng.integers(0, 12, 50)
    assert T_met.topk_accuracy(torch.from_numpy(logits), labels, (1, 3, 5)) == \
        J_met.topk_accuracy(logits, labels, (1, 3, 5))
    real = [list(rng.choice(12, size=rng.integers(0, 4), replace=False)) for _ in range(50)]
    for k in (1, 2):
        assert T_met.real_labels_accuracy(logits, real, k) == \
            J_met.real_labels_accuracy(logits, real, k)
    pred = rng.integers(0, 6, 300)
    target = np.where(rng.random(300) < 0.1, 255, rng.integers(0, 6, 300))
    cm = T_met.confusion_matrix(torch.from_numpy(pred), target, 6)
    np.testing.assert_array_equal(cm, J_met.confusion_matrix(pred, target, 6))
    for exclude in ((), (0,), (0, 255)):
        assert T_met.miou_from_confusion(cm, exclude) == J_met.miou_from_confusion(cm, exclude)


# ---- k-NN ------------------------------------------------------------------------


def _knn_data(seed, n_tr=300, n_te=70, d=16, classes=7):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((classes, d)) * 2.0
    ytr = rng.integers(0, classes, n_tr)
    yte = rng.integers(0, classes, n_te)
    xtr = (centers[ytr] + rng.standard_normal((n_tr, d))).astype(np.float32)
    xte = (centers[yte] + rng.standard_normal((n_te, d))).astype(np.float32)
    return xtr, ytr, xte, yte


def _unit_bf16_rows(rng, n, d=16):
    """Rows whose bf16 squares sum to exactly 1 (entries +-1/2 and +-1/4 in
    the patterns 4 x 1/2, 3 x 1/2 + 4 x 1/4, 16 x 1/4), so that the
    normalisation is the identity on both sides; their similarities are
    multiples of 1/16 and tie often."""
    rows = np.zeros((n, d), np.float32)
    for r in rows:
        halves, quarters = [(4, 0), (3, 4), (0, 16)][rng.integers(0, 3)]
        pos = rng.permutation(d)[: halves + quarters]
        r[pos] = np.r_[np.full(halves, 0.5), np.full(quarters, 0.25)] * rng.choice([-1, 1],
                                                                                      len(pos))
    return rows


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_knn_classify_votes_match_jax(dtype):
    """f32 on Gaussian features; bf16 on unit-norm rows with many tied
    similarities (the k-th neighbour decided by the lower train index, as
    ``lax.top_k`` does). XLA's bf16 square root is not correctly rounded
    (sqrt(60.5) -> 7.75, where 7.78125 is nearest), so Gaussian bf16
    features would hold the port to that rounding (ROADMAP.md Queue 3)."""
    xtr, ytr, xte, _ = _knn_data(81)
    if dtype == "bfloat16":
        rng = np.random.default_rng(181)
        xtr, xte = _unit_bf16_rows(rng, len(xtr)), _unit_bf16_rows(rng, len(xte))
    ks = (1, 5, 20)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    theirs = J_knn.knn_classify(jnp.asarray(xtr).astype(jdt), ytr, jnp.asarray(xte).astype(jdt),
                                7, ks=ks, batch_size=32)
    ours = T_knn.knn_classify(torch.from_numpy(xtr).to(tdt), torch.from_numpy(ytr),
                              torch.from_numpy(xte).to(tdt), 7, ks=ks, batch_size=32)
    for k in ks:
        assert ours[k].dtype == torch.float32
        _close(ours[k], theirs[k], msg=f"k={k}")


def test_topk_lowest_index_first_matches_lax():
    rng = np.random.default_rng(182)
    sims = rng.integers(0, 5, (9, 40)).astype(np.float32)  # ties everywhere
    for k in (1, 3, 8, 40):
        jv, ji = jax.lax.top_k(jnp.asarray(sims), k)
        tv, ti = T_knn.topk_lowest_index_first(torch.from_numpy(sims), k)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_evaluate_knn_and_filter_match_jax():
    xtr, ytr, xte, yte = _knn_data(82)
    for n_per_class in (None, 5):
        theirs = J_knn.evaluate_knn(xtr, ytr, xte, yte, 7, ks=(1, 10, 20), n_per_class=n_per_class)
        ours = T_knn.evaluate_knn(torch.from_numpy(xtr), torch.from_numpy(ytr),
                                  torch.from_numpy(xte), yte, 7, ks=(1, 10, 20),
                                  n_per_class=n_per_class)
        assert ours == theirs, n_per_class
    for seed in (0, 3):
        jf, jl = J_knn.filter_n_per_class(xtr, ytr, 4, seed=seed)
        tf, tl = T_knn.filter_n_per_class(torch.from_numpy(xtr), torch.from_numpy(ytr), 4,
                                          seed=seed)
        np.testing.assert_array_equal(tf.numpy(), jf)
        np.testing.assert_array_equal(tl.numpy(), jl)


def test_extract_features_stays_on_device_with_int64_labels():
    batches = [(np.full((3, 2), i, np.float32), np.arange(3) + i) for i in range(4)]
    f, y = T_knn.extract_features(lambda x: torch.from_numpy(x) * 2, iter(batches))
    jf, jy = J_knn.extract_features(lambda x: x * 2, iter(batches))
    assert f.device.type == "cpu" and y.dtype == torch.int64
    np.testing.assert_array_equal(f.numpy(), jf)
    np.testing.assert_array_equal(y.numpy(), jy)


# ---- linear probes ----------------------------------------------------------------


def test_linear_probe_bank_steps_match_jax():
    rng = np.random.default_rng(83)
    d, c, b = 24, 9, 16
    lrs = tuple(T_lin.scale_lr(lr, b) for lr in T_lin.DEFAULT_LRS)
    jbank = J_lin.LinearProbeBank(d, c, lrs, iters=5)
    tbank = T_lin.LinearProbeBank(d, c, lrs, iters=5, device="cpu")
    for it in range(5):
        feats = rng.standard_normal((b, d)).astype(np.float32) * 3
        labels = rng.integers(0, c, b)
        jl = jbank.train_step(jnp.asarray(feats), jnp.asarray(labels), it)
        tl = tbank.train_step(torch.from_numpy(feats), torch.from_numpy(labels), it)
        _close(tl, jl, msg=f"loss at {it}")
    for name in ("w", "b", "mw", "mb"):
        _close(getattr(tbank, name), getattr(jbank, name), msg=name)


def _probe_data(seed, n, d=16, n_tok=5, classes=4, blocks=4):
    """(images, labels): an "image" is its index; features are a fixed table
    of per-block (patch tokens, cls) computed from class centres."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((classes, d)) * 1.5
    y = rng.integers(0, classes, n)
    patch = (centers[y][:, None, None] + rng.standard_normal((n, blocks, n_tok, d))).astype(
        np.float32)
    cls = (centers[y][:, None] + rng.standard_normal((n, blocks, d))).astype(np.float32)
    return patch, cls, y


def test_train_and_eval_linear_probes_match_jax():
    patch, cls, y = _probe_data(84, 96)
    idx = np.arange(96)

    def batches(lo, hi, bs=16):
        return [(idx[i:i + bs], y[i:i + bs]) for i in range(lo, hi, bs)]

    def jfeat(ii):
        return [(jnp.asarray(patch[ii, k]), jnp.asarray(cls[ii, k])) for k in range(4)]

    def tfeat(ii):
        return [(torch.from_numpy(patch[ii, k]), torch.from_numpy(cls[ii, k])) for k in range(4)]

    kw = dict(num_classes=4, iters=12, batch_size=16)
    theirs = J_lin.train_and_eval_linear_probes(jfeat, lambda: batches(0, 64), batches(64, 96),
                                                **kw)
    ours = T_lin.train_and_eval_linear_probes(tfeat, lambda: batches(0, 64), batches(64, 96),
                                              **kw)
    assert ours == theirs


# ---- attention-pool probes ----------------------------------------------------------


def _to_port_bank(tree) -> dict:
    """A JAX bank (``_bank_init``'s tree) -> the port's parameter names."""
    out = {"weight": tree["Dense_0"]["kernel"], "bias": tree["Dense_0"]["bias"]}
    if "kv" in tree:
        out.update(query_token=tree["query_token"], kv_weight=tree["kv"]["kernel"],
                   kv_bias=tree["kv"]["bias"])
    return {k: np.array(v) for k, v in out.items()}


@pytest.mark.parametrize("d,heads", [(128, 2), (48, 1)])
def test_attnpool_classifier_matches_flax(d, heads):
    rng = np.random.default_rng(85 + d)
    x = rng.standard_normal((3, 6, d)).astype(np.float32)
    module = J_ap.AttnPoolClassifier(num_classes=5)
    bank = J_ap._bank_init(module, jax.random.PRNGKey(d), jnp.asarray(x), 4)
    theirs = jax.vmap(lambda p: module.apply({"params": p}, jnp.asarray(x)))(bank)
    tmod = T_ap.AttnPoolClassifier(d, 5, 4)
    assert tmod.heads == heads
    with torch.no_grad():
        for name, p in tmod.named_parameters():
            p.copy_(torch.as_tensor(_to_port_bank(bank)[name]))
        _close(tmod(torch.from_numpy(x)), theirs)


def test_train_probe_grid_matches_jax():
    patch, cls, y = _probe_data(86, 96, d=128, blocks=1)
    patch, cls = patch[:, 0], cls[:, 0]
    idx = np.arange(96)

    def batches(lo, hi, bs=16):
        return [(idx[i:i + bs], y[i:i + bs]) for i in range(lo, hi, bs)]

    def feats(ii):
        return {"cls": cls[ii], "avg_patch": patch[ii].mean(1), "patch": patch[ii]}

    grid = dict(learning_rates=(1e-3, 1e-2), weight_decays=(1e-4, 5e-2), n_iters=8,
                warmup_iters=3, batch_size=16, seed=4)
    theirs = J_ap.train_probe_grid(feats, lambda: batches(0, 64), batches(64, 96), 4, **grid)
    first = feats(idx[:16])
    init = {}
    for rep in ("cls", "avg_patch", "patch"):
        module = (J_ap.AttnPoolClassifier if rep == "patch" else J_ap.LinearClassifier)(
            num_classes=4)
        init[rep] = _to_port_bank(J_ap._bank_init(module, jax.random.PRNGKey(4),
                                                  jnp.asarray(first[rep]), 4))
    ours = T_ap.train_probe_grid(lambda ii: {k: torch.from_numpy(np.ascontiguousarray(v))
                                             for k, v in feats(ii).items()},
                                 lambda: batches(0, 64), batches(64, 96), 4, init_banks=init,
                                 **grid)
    assert set(ours) == set(theirs)
    for key, v in theirs.items():
        if key == "final_loss":
            _close(ours[key], v)
        else:
            assert ours[key] == v, key


# ---- segmentation ---------------------------------------------------------------------


@pytest.mark.parametrize("ignore", [(255,), (0, 255)])
def test_downsample_labels_matches_jax(ignore):
    rng = np.random.default_rng(90)
    for trial in range(4):
        # few classes and 4 x 4 patches: many ties; some patches all ignored
        lab = rng.integers(0, 4, (18, 21)).astype(np.int32)
        lab[rng.random(lab.shape) < 0.3] = 255
        lab[:4, :4] = 255
        np.testing.assert_array_equal(T_seg.downsample_labels(lab, 4, 4, ignore),
                                      J_seg.downsample_labels(lab, 4, 4, ignore))


def test_extract_patch_features_matches_jax():
    rng = np.random.default_rng(91)
    w = rng.standard_normal((3, 8)).astype(np.float32)
    data = [(rng.standard_normal((16, 16, 3)).astype(np.float32),
             rng.integers(0, 3, (16, 16)) * (rng.random((16, 16)) < 0.8)) for _ in range(3)]

    def jfn(batch):  # [1, 16, 16, 3] -> [1, 16 patches, 8]
        return batch.reshape(1, 4, 4, 4, 4, 3).mean((2, 4)).reshape(1, 16, 3) @ w

    tf, tl = T_seg.extract_patch_features(lambda b: torch.from_numpy(jfn(b)), data, 4, 3, (0, 255))
    jf, jl = J_seg.extract_patch_features(jfn, data, 4, 3, (0, 255))
    np.testing.assert_array_equal(tf.numpy(), jf)
    np.testing.assert_array_equal(tl, jl)


@pytest.mark.parametrize("distance", ["cosine", "L2"])
def test_knn_seg_probe_matches_jax(distance):
    """Duplicated train rows with other labels, so that equal similarities
    straddle the k-th place (integer-valued features under L2, where every
    distance is exact; Gaussian ones under cosine, where rows that are not
    copies never tie); the bank tiled finer than the data (tiles of 7 rows,
    queries 5 at a time)."""
    rng = np.random.default_rng(92)
    if distance == "L2":
        base = rng.integers(-3, 4, (40, 6)).astype(np.float32)
        extra = rng.integers(-3, 4, (20, 6)).astype(np.float32)
    else:
        base, extra = (rng.standard_normal((m, 6)).astype(np.float32) for m in (40, 20))
    tr = np.concatenate([base, base[:25]])
    ytr = rng.integers(0, 5, len(tr))
    va = np.concatenate([base[::3], extra])
    for k in (1, 3, 10, 30):
        theirs = J_seg.KNNSegProbe(k, distance, 5).fit(tr, ytr).predict(va)
        ours = T_seg.KNNSegProbe(k, distance, 5, chunk=5, bank_tile=7).fit(
            torch.from_numpy(tr), ytr).predict(torch.from_numpy(va))
        np.testing.assert_array_equal(ours, theirs, err_msg=f"k={k}")


def _logreg_data():
    """tests/test_eval_extras.py:196's case: 4 classes, 219 rows."""
    rng = np.random.RandomState(1)
    centers = rng.randn(4, 16) * 4
    y = np.tile(np.arange(4), 55)[:219]
    x = (centers[y] + 0.15 * rng.randn(219, 16)).astype(np.float32)
    va_y = np.tile(np.arange(4), 10)
    va_x = (centers[va_y] + 0.15 * rng.randn(40, 16)).astype(np.float32)
    return x, y, va_x


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - b) / np.linalg.norm(b))


def test_logreg_host_matches_sklearn_backend():
    """The host backend (scipy, f64) against the JAX sklearn backend, both
    on the f64 features (with f32 input sklearn computes in f32 and stops
    early)."""
    x, y, va_x = _logreg_data()
    x = x.astype(np.float64)
    theirs = J_seg.LogregSegProbe(C=1.0, max_iter=1000, num_classes=4, backend="sklearn").fit(x, y)
    ours = T_seg.LogregSegProbe(C=1.0, max_iter=1000, num_classes=4, backend="host").fit(x, y)
    np.testing.assert_array_equal(ours.predict(va_x), theirs.predict(va_x))
    assert _rel(ours._w, theirs.clf.coef_.T) < 1e-3
    jb = theirs.clf.intercept_
    assert _rel(ours._b - ours._b.mean(), jb - jb.mean()) < 1e-3


def test_logreg_device_backend_on_cpu_tensors():
    """The device backend on CPU tensors, chunk 64 over 219 rows (a ragged
    last chunk). Predictions equal those of the JAX "jax" backend on the
    same case. W and b are held to the minimiser of the objective on the
    bf16-rounded features (the JAX sklearn backend in f64), within 1e-3: the
    JAX "jax" backend stops 1.85% (W, relative) from it, because it rounds W
    to bf16 in its logits (ROADMAP.md Queue 3)."""
    x, y, va_x = _logreg_data()
    jx = J_seg.LogregSegProbe(C=1.0, max_iter=200, num_classes=4, backend="jax",
                              chunk_size=64).fit(x, y)
    ours = T_seg.LogregSegProbe(C=1.0, max_iter=200, num_classes=4, backend="device",
                                chunk_size=64).fit(torch.from_numpy(x), y)
    np.testing.assert_array_equal(ours.predict(torch.from_numpy(va_x)), jx.predict(va_x))
    assert 1 < ours.n_iter_ <= 200
    assert ours.objective_[1] < ours.objective_[0]
    xb = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    exact = J_seg.LogregSegProbe(C=1.0, max_iter=1000, num_classes=4, backend="sklearn").fit(xb, y)
    assert _rel(ours._w.numpy(), exact.clf.coef_.T) < 1e-3
    b, jb = ours._b.numpy(), exact.clf.intercept_
    assert _rel(b - b.mean(), jb - jb.mean()) < 1e-3
    assert _rel(jx._w, exact.clf.coef_.T) > 1e-2  # the JAX backend's shortfall, pinned


def test_logreg_auto_backend_follows_the_features(monkeypatch):
    """"auto" fits a CPU tensor on the host; an array goes to the card, and
    without one it raises rather than fit on the CPU."""
    x, y, _ = _logreg_data()
    probe = T_seg.LogregSegProbe(max_iter=5, num_classes=4).fit(torch.from_numpy(x), y)
    assert probe.backend_ == "host"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T_seg.LogregSegProbe(max_iter=5, num_classes=4).fit(x, y)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_logreg_rejects_empty_input(backend):
    probe = T_seg.LogregSegProbe(num_classes=3, backend=backend)
    with pytest.raises(ValueError):
        probe.fit(torch.zeros(0, 8), np.zeros(0, np.int64))


@pytest.mark.parametrize("grid_slice", [(0, 2), (1, 2)])
def test_evaluate_seg_probes_matches_jax(grid_slice):
    rng = np.random.default_rng(93)
    centers = rng.standard_normal((5, 12)) * 2.0
    ytr = rng.integers(1, 5, 400)
    yva = np.concatenate([rng.integers(1, 5, 150), np.full(10, 255), np.zeros(10, np.int64)])
    xtr = centers[ytr] + rng.standard_normal((400, 12))
    xva = centers[yva % 5] + rng.standard_normal((170, 12))
    kw = dict(knn_grid=({"k": 3, "distance": "cosine"}, {"k": 10, "distance": "L2"}),
              logreg_grid=({"C": 0.1, "max_iter": 500, "tol": 1e-12},
                           {"C": 1.0, "max_iter": 500, "tol": 1e-12}),
              grid_slice=grid_slice, ignore_labels=(0, 255))
    theirs = J_seg.evaluate_seg_probes(xtr, ytr, xva, yva, 5, **kw)
    ours = T_seg.evaluate_seg_probes(torch.from_numpy(xtr), ytr, torch.from_numpy(xva), yva, 5,
                                     **kw)
    assert [(r.probe, r.params) for r in ours] == [(r.probe, r.params) for r in theirs]
    for o, t in zip(ours, theirs):
        assert abs(o.miou - t.miou) <= 1e-6 and abs(o.acc - t.acc) <= 1e-6, (o, t)
