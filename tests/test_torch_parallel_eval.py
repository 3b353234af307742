"""The port's sharded evaluation over 2 and 4 gloo processes on the CPU
against the JAX package: the feature gather and the sharded extraction
(``eval/distributed.py``) against the one-process bank and JAX's
``EpochSampler`` and ``extract_features``, ``knn_classify_sharded`` against
JAX's on a CPU mesh of as many devices, the data-parallel probe bank and grid
(``LinearProbeBank(mesh=)``, ``train_and_eval_linear_probes(mesh=)``)
against JAX's with ``mesh=``, the global KoLeo against ``koleo_loss`` of the
whole batch, and the ``eval_dinov2`` command line at 2 processes against one.
Each world's processes run every case once a module
(``tests/torch_dist.py:eval_worker``, spawn, a ``FileStore``) under the
suite's time limit; f32 unless a test says otherwise."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from PIL import Image

from octic_vits_tpu.data.samplers import EpochSampler as JEpochSampler
from octic_vits_tpu.eval import distributed as J_dist
from octic_vits_tpu.eval import knn as J_knn
from octic_vits_tpu.eval import linear as J_lin
from octic_vits_tpu_torch.eval import distributed as T_dist
from octic_vits_tpu_torch.eval import knn as T_knn
from octic_vits_tpu_torch.eval import linear as T_lin
from octic_vits_tpu_torch.scripts import eval_dinov2 as T_cli
from octic_vits_tpu_torch.train.dinov2 import losses as T_L

import torch_dist
from test_torch_depth import reference_dinov2
from test_torch_eval import _unit_bf16_rows
from torch_time_limit import alarm

torch.set_num_threads(1)
TOL = 1e-5
WORLDS = (2, 4)
KNN_KS, KNN_CLASSES = (1, 5, 10), 7
LRS, BANK_CLASSES = (1e-3, 1e-2, 1e-1), 5
GRID_BATCH, GRID_CLASSES = 8, 3


def _knn_data(seed, n_tr=48, n_te=20, d=16):
    rng = np.random.default_rng(seed)
    centers = 2.0 * rng.standard_normal((KNN_CLASSES, d))
    ytr = rng.integers(0, KNN_CLASSES, n_tr)
    xtr = (centers[ytr] + rng.standard_normal((n_tr, d))).astype(np.float32)
    xte = (centers[rng.integers(0, KNN_CLASSES, n_te)]
           + rng.standard_normal((n_te, d))).astype(np.float32)
    return xtr, ytr, xte


def _difference_data():
    """42 rows of width 8 (JAX pads them to 44 over 4 devices): a positive
    bank and negative queries, so that every similarity is below 0; and a
    Gaussian bank whose 11-row blocks are shorter than k = 20."""
    rng = np.random.default_rng(43)
    pos = np.abs(rng.standard_normal((42, 8))).astype(np.float32)
    neg = -np.abs(rng.standard_normal((6, 8))).astype(np.float32)
    y = rng.integers(0, 4, 42)
    gauss = rng.standard_normal((42, 8)).astype(np.float32)
    return {"pad_ranks": (pos, y, neg, 4, (10,), 16, "float32"),
            "short_shards": (gauss, y, rng.standard_normal((6, 8)).astype(np.float32), 4, (20,),
                             16, "float32")}


def _knn_cases(world):
    xtr, ytr, xte = _knn_data(91)
    rng = np.random.default_rng(191)
    utr, ute = _unit_bf16_rows(rng, len(xtr)), _unit_bf16_rows(rng, len(xte))
    cases = {"gaussian": (xtr, ytr, xte, KNN_CLASSES, KNN_KS, 8, "float32"),
             "ties_float32": (utr, ytr, ute, KNN_CLASSES, KNN_KS, 8, "float32"),
             "ties_bfloat16": (utr, ytr, ute, KNN_CLASSES, KNN_KS, 8, "bfloat16")}
    if world == 4:
        cases.update(_difference_data())
    return cases


def _bank_case():
    rng = np.random.default_rng(92)
    feats = [rng.standard_normal((8, 6)).astype(np.float32) for _ in range(3)]
    labels = [rng.integers(0, BANK_CLASSES, 8) for _ in range(3)]
    return feats, labels, LRS, BANK_CLASSES


def _grid_case():
    rng = np.random.default_rng(93)

    def batch(b):
        return (rng.standard_normal((b, 4, 3, 4)).astype(np.float32),
                rng.integers(0, GRID_CLASSES, b))
    return [batch(GRID_BATCH) for _ in range(3)], [batch(6), batch(6)], GRID_CLASSES, GRID_BATCH


def _koleo_cls():
    return np.random.default_rng(94).standard_normal((8, 6)).astype(np.float32)


def _write_folder(root):
    """An ImageFolder of 2 classes, 3 train and 2 val JPEGs each."""
    rng = np.random.default_rng(95)
    for split, per_class in (("train", 3), ("val", 2)):
        for c in range(2):
            os.makedirs(root / split / f"c{c}")
            for i in range(per_class):
                arr = np.clip(rng.normal(60 + 120 * c, 40, (48, 64, 3)), 0, 255).astype(np.uint8)
                Image.fromarray(arr).save(root / split / f"c{c}" / f"{i}.jpg", quality=90)
    pth = str(root / "dinov2_vits14_pretrain.pth")
    torch.save(reference_dinov2(grid=16, scale=0.02), pth)
    common = ["--model", "dinov2_vits14", "--checkpoint", pth, "--train-data",
              str(root / "train"), "--val-data", str(root / "val"), "--batch", "2", "--workers",
              "2", "--num-classes", "2", "--device", "cpu"]
    return {"knn": ["knn"] + common, "linear": ["linear"] + common + ["--iters", "2"]}


def _cases(world, tmp):
    return {"gather": [(5, "float32"), (7, "float32"), (7, "bfloat16")],
            "extract": (7, 9, world - 1),
            "knn": _knn_cases(world), "bank": _bank_case(), "grid": _grid_case(),
            "koleo": _koleo_cls(), "cli": _write_folder(tmp) if world == 2 else None}


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """world -> (its cases, each rank's results), started once a module."""
    cache = {}

    def get(world):
        if world not in cache:
            tmp = tmp_path_factory.mktemp(f"eval{world}")
            cases = _cases(world, tmp)
            with alarm():
                cache[world] = cases, torch_dist.run_processes(torch_dist.eval_worker, world,
                                                               tmp, cases)
        return cache[world]
    return get


def _jax_mesh(world):
    return Mesh(np.array(jax.devices()[:world]), ("data",))


# ---- the gather and the sharded extraction ---------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_gather_equals_the_one_process_bank(groups, world):
    """Round-robin shards of 5 and 7 rows (ragged at both worlds, one shard
    padded with index -1), in f32 and bf16: every process gets every row in
    dataset order, bitwise."""
    cases, ranks = groups(world)
    for total, dtype in cases["gather"]:
        whole = torch.from_numpy(np.random.default_rng(total).standard_normal((total, 3))
                                 .astype(np.float32)).to(getattr(torch, dtype))
        for rank, got in enumerate(ranks):
            f, y = got["gather"][(total, dtype)]
            assert f.dtype == whole.dtype and torch.equal(f, whole), (rank, total, dtype)
            assert torch.equal(y, torch.arange(total) * 10), (rank, total)


def test_single_process_gather_is_pure_scatter_as_jax():
    """tests/test_multihost.py:test_single_process_gather_is_pure_scatter's
    case on both packages (no process group: no collective)."""
    idx = np.array([3, 0, 2, 1])
    feats = np.arange(8, dtype=np.float32).reshape(4, 2)
    labels = np.array([30, 0, 20, 10])
    jf, jy = J_dist.gather_features_across_processes(feats, labels, idx, 4)
    tf, ty = T_dist.gather_features_across_processes(torch.from_numpy(feats),
                                                     torch.from_numpy(labels),
                                                     torch.from_numpy(idx), 4)
    np.testing.assert_array_equal(tf.numpy(), jf)
    np.testing.assert_array_equal(ty.numpy(), jy)
    assert ty.tolist() == [0, 10, 20, 30]


@pytest.mark.parametrize("world", WORLDS)
def test_extract_features_sharded_matches_jax(groups, world):
    """Each process's indices are JAX's ``EpochSampler(n, shard=r,
    num_shards=w)``; the merged bank is JAX's one-process
    ``extract_features_sharded`` (its ``extract_features`` plus the reorder),
    bitwise. A dataset smaller than the world raises ``ValueError`` on every
    process (JAX's ``np.concatenate([])`` raises on the processes with an
    empty shard alone, and the others wait in the gather)."""
    cases, ranks = groups(world)
    for n in cases["extract"]:
        for rank, got in enumerate(ranks):
            case = got["extract"][n]
            assert case["indices"] == list(JEpochSampler(n, shard=rank, num_shards=world)), n
            if n < world:
                assert "ValueError" in case["bank"] and "processes" in case["bank"], case["bank"]
                continue
            jf, jy = J_dist.extract_features_sharded(
                lambda images: np.asarray(images).mean(axis=(1, 2)), torch_dist.ToyDataset(n),
                batch_size=2, num_workers=1)
            tf, ty = case["bank"]
            np.testing.assert_array_equal(tf.numpy(), jf)
            np.testing.assert_array_equal(ty.numpy(), jy)


# ---- the sharded k-NN ------------------------------------------------------------------

def _jax_knn(case, world, dtype):
    xtr, ytr, xte, classes, ks, batch, _ = case
    jdt = getattr(jnp, dtype)
    args = (jnp.asarray(xtr).astype(jdt), jnp.asarray(ytr), jnp.asarray(xte).astype(jdt),
            classes)
    return (J_knn.knn_classify_sharded(*args, _jax_mesh(world), ks=ks, batch_size=batch),
            J_knn.knn_classify(*args, ks=ks, batch_size=batch))


@pytest.mark.parametrize("world", WORLDS)
def test_knn_classify_sharded_matches_jax(groups, world):
    """48 rows (no JAX padding; every block holds at least k = 10 rows), 20
    queries in chunks of 8, f32: Gaussian features, and the unit rows of
    ``test_knn_classify_votes_match_jax[bfloat16]`` (exact in f32), whose
    similarities are multiples of 1/16 and tie often, so that the merge's
    order among ties (the lower block, then the lower row, as ``lax.top_k``
    over JAX's tiled gather) decides neighbours. Votes within 1e-5 of JAX's
    ``knn_classify_sharded`` on a mesh of `world` CPU devices, the same
    predictions, the same votes on every process."""
    cases, ranks = groups(world)
    for name in ("gaussian", "ties_float32"):
        case = cases["knn"][name]
        sharded, _ = _jax_knn(case, world, "float32")
        for rank, got in enumerate(ranks):
            for k in case[4]:
                v = got["knn"][name]["sharded"][k]
                assert v.dtype == torch.float32 and v.shape == (len(case[2]), case[3])
                np.testing.assert_allclose(v.numpy(), np.asarray(sharded[k]), rtol=TOL, atol=TOL,
                                           err_msg=f"{name} rank {rank} k={k}")
                np.testing.assert_array_equal(v.argmax(1).numpy(),
                                              np.asarray(sharded[k]).argmax(1))
                assert torch.equal(v, ranks[0]["knn"][name]["sharded"][k])


@pytest.mark.parametrize("world", WORLDS)
def test_knn_classify_sharded_bf16_is_knn_classify(groups, world):
    """The tied unit rows in bf16: the port's sharded votes equal its
    ``knn_classify``'s bitwise and JAX's ``knn_classify``'s within 1e-5.
    Difference (c): JAX's sharded form takes the weights ``exp(s / T)`` in
    f32 (eval/knn.py:141) where its ``knn_classify`` takes them in the
    features' dtype (:61), so its bf16 sharded votes differ from its own
    single-device votes by the bf16 rounding of ``s / T`` (here by more than
    1e-3 relative); the port takes both in the features' dtype. The
    predictions agree."""
    cases, ranks = groups(world)
    case = cases["knn"]["ties_bfloat16"]
    sharded, single = _jax_knn(case, world, "bfloat16")
    assert max(np.abs(np.asarray(sharded[k]) - np.asarray(single[k])).max()
               / np.abs(np.asarray(single[k])).max() for k in case[4]) > 1e-3
    for rank, got in enumerate(ranks):
        ours = got["knn"]["ties_bfloat16"]
        for k in case[4]:
            assert torch.equal(ours["sharded"][k], ours["plain"][k]), (rank, k)
            np.testing.assert_allclose(ours["sharded"][k].numpy(), np.asarray(single[k]),
                                       rtol=TOL, atol=TOL, err_msg=f"rank {rank} k={k}")
            np.testing.assert_array_equal(ours["sharded"][k].argmax(1).numpy(),
                                          np.asarray(sharded[k]).argmax(1))


def test_knn_sharded_never_ranks_padding(groups):
    """Difference (a): JAX pads the 42-row bank to 44 over 4 devices with
    zero rows labelled -1. Every similarity of these queries is below 0, so
    the padding's 0 displaces a real neighbour of each query and then votes
    0: JAX's sharded votes differ from its ``knn_classify``'s. The port ranks
    no padding and equals its ``knn_classify`` (and JAX's, within 1e-5)."""
    cases, ranks = groups(4)
    xtr, ytr, xte, classes, ks, batch, _ = cases["knn"]["pad_ranks"]
    jax_sharded = J_knn.knn_classify_sharded(xtr, ytr, xte, classes, _jax_mesh(4), ks=ks,
                                             batch_size=batch)[10]
    jax_single = J_knn.knn_classify(xtr, ytr, xte, classes, ks=ks, batch_size=batch)[10]
    gap = np.abs(np.asarray(jax_sharded) - np.asarray(jax_single)).max(1)
    assert (gap > 1e-3 * np.abs(np.asarray(jax_single)).max(1)).all()
    for got in ranks:
        ours = got["knn"]["pad_ranks"]
        assert torch.equal(ours["sharded"][10], ours["plain"][10])
        np.testing.assert_allclose(ours["sharded"][10].numpy(), np.asarray(jax_single), rtol=TOL,
                                   atol=TOL)


def test_knn_sharded_takes_short_shards(groups):
    """Difference (b): over 4 devices each of JAX's blocks holds 11 rows,
    fewer than k = 20, and its ``lax.top_k`` raises. The port's blocks give
    all their rows and the merge takes the top 20: its ``knn_classify``'s
    votes, and JAX's ``knn_classify``'s within 1e-5."""
    cases, ranks = groups(4)
    xtr, ytr, xte, classes, ks, batch, _ = cases["knn"]["short_shards"]
    with pytest.raises(ValueError):
        J_knn.knn_classify_sharded(xtr, ytr, xte, classes, _jax_mesh(4), ks=ks, batch_size=batch)
    jax_single = J_knn.knn_classify(xtr, ytr, xte, classes, ks=ks, batch_size=batch)[20]
    for got in ranks:
        ours = got["knn"]["short_shards"]
        assert torch.equal(ours["sharded"][20], ours["plain"][20])
        np.testing.assert_allclose(ours["sharded"][20].numpy(), np.asarray(jax_single), rtol=TOL,
                                   atol=TOL)


# ---- the data-parallel probe bank and grid ---------------------------------------------

@pytest.mark.parametrize("split", ["even", "ragged"])
@pytest.mark.parametrize("world", WORLDS)
def test_linear_probe_bank_matches_jax_mesh(groups, world, split):
    """3 steps of a 3-classifier bank: parameters, momenta and losses within
    1e-5 of JAX's, the classifiers bitwise equal on every process. "even":
    each process on its block of the global batch of 8, against JAX's
    ``LinearProbeBank(mesh=)`` fed the global batch. "ragged": a global
    batch of 7 dealt round robin, so the processes hold different numbers of
    rows (4 + 3; 2 + 2 + 2 + 1), against JAX's bank on the 7 rows without a
    mesh (its sharded batch refuses an uneven split): the step is still the
    mean over the global batch."""
    cases, ranks = groups(world)
    feats, labels, lrs, classes = cases["bank"]
    rows, mesh = (8, _jax_mesh(world)) if split == "even" else (7, None)
    jbank = J_lin.LinearProbeBank(feats[0].shape[1], classes, lrs, iters=5, mesh=mesh)
    jlosses = [np.asarray(jbank.train_step(jnp.asarray(f[:rows]), jnp.asarray(y[:rows]), it))
               for it, (f, y) in enumerate(zip(feats, labels))]
    for rank, got in enumerate(ranks):
        params, losses = got["linear"]["bank"][split]
        for n in ("w", "b", "mw", "mb"):
            np.testing.assert_allclose(params[n].numpy(), np.asarray(getattr(jbank, n)),
                                       rtol=TOL, atol=TOL, err_msg=f"rank {rank} {n}")
            assert torch.equal(params[n], ranks[0]["linear"]["bank"][split][0][n])
        for ours, theirs in zip(losses, jlosses):
            np.testing.assert_allclose(ours.numpy(), theirs, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_linear_probe_grid_matches_jax_mesh(groups, world):
    """The grid on a stand-in backbone (4 blocks of 2 patch tokens and a cls
    token of width 4), 4 iterations at a global batch of 8, each process
    training on its rows and scoring its rows of a 12-image validation set
    (ragged at 4 processes): every process returns JAX's
    ``train_and_eval_linear_probes(mesh=)`` results on the global batches,
    which are the port's one-process results. A world that does not divide
    the batch raises ``ValueError``."""
    cases, ranks = groups(world)
    train, val, classes, batch = cases["grid"]

    def jfeats(x):
        x = jnp.asarray(x)
        return [(x[:, j, 1:], x[:, j, 0]) for j in range(x.shape[1])]

    kw = dict(iters=len(train) + 1, lrs=(1e-2, 1e-1), batch_size=batch)
    theirs = J_lin.train_and_eval_linear_probes(jfeats, lambda: train, val, classes,
                                                mesh=_jax_mesh(world), **kw)
    one = T_lin.train_and_eval_linear_probes(
        torch_dist.probe_features, lambda: [(torch.from_numpy(x), torch.from_numpy(y))
                                            for x, y in train], val, classes, **kw)
    assert one == theirs
    for got in ranks:
        assert got["linear"]["grid"] == theirs
        assert "does not split" in got["linear"]["uneven"]


# ---- the global KoLeo ------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_koleo_global_is_koleo_over_the_gathered_batch(groups, world):
    """Each process's rows gathered in rank order: the loss is ``koleo_loss``
    of the whole batch on every process (within 1e-6), and a process's rows
    get `world` times that loss's gradient (the gather's backward sums the
    processes' cotangents; the step's mean over processes divides by
    `world` again)."""
    cases, ranks = groups(world)
    whole = torch.from_numpy(cases["koleo"]).requires_grad_(True)
    loss = T_L.koleo_loss(whole)
    loss.backward()
    for rank, got in enumerate(ranks):
        np.testing.assert_allclose(got["koleo"]["loss"].numpy(), loss.detach().numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["koleo"]["grad"].numpy(),
                                   world * whole.grad.chunk(world)[rank].numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_koleo_global_without_a_group_is_koleo_loss():
    x = torch.from_numpy(_koleo_cls())
    a, b = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    la, lb = T_L.koleo_loss_global(a), T_L.koleo_loss(b)
    (la + lb).backward()
    assert torch.equal(la, lb) and torch.equal(a.grad, b.grad)


# ---- the eval command line -------------------------------------------------------------

@pytest.mark.parametrize("mode", ["knn", "linear"])
def test_eval_dinov2_two_processes_match_one(groups, tmp_path, monkeypatch, capsys, mode):
    """``eval_dinov2`` under a 2-process gloo group on the CPU (a random
    ``dinov2_vits14`` reference checkpoint, 6 train and 4 val JPEGs, k in
    (1, 3)): knn extracts each process's shard of both folders and merges
    them, linear trains the whole grid on every process (JAX passes no
    mesh); both processes return the one-process result, and only process 0
    prints it."""
    cases, ranks = groups(2)
    argv = cases["cli"][mode]
    monkeypatch.setattr(T_knn, "evaluate_knn", functools.partial(T_knn.evaluate_knn, ks=(1, 3)))
    one = T_cli.main(argv)
    assert json.loads(capsys.readouterr().out) == one
    for rank, got in enumerate(ranks):
        assert got["cli"][mode]["result"] == one, rank
    assert json.loads(ranks[0]["cli"][mode]["printed"]) == one
    assert ranks[1]["cli"][mode]["printed"] == ""
