"""The port's mesh, sharding rule and launcher, without processes: the
``(data, fsdp)`` layout against JAX's ``create_mesh`` and its node check,
``leaf_partition_spec`` against JAX's on every leaf of the hybrid ViT-H/14
and a small model, the FSDP2 placement, the batch's split and the SSL
batch's share, the draws of a global batch's masks, torchrun's environment,
the backend and the device, the launcher's dispatch, and that no kernel
wrapper caches anything by a tensor's address (under ZeRO-3 a parameter is
freed and gathered again each step)."""

import importlib
import inspect
import pkgutil
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octic_vits_tpu.models.registry import create_model as j_create_model
from octic_vits_tpu.parallel import create_mesh as j_create_mesh
from octic_vits_tpu.parallel.sharding import leaf_partition_spec as j_leaf_partition_spec
from octic_vits_tpu_torch import create_model, launch
from octic_vits_tpu_torch.data.mixup import MixDraws, mixup_cutmix
from octic_vits_tpu_torch.layers.common import drop_path_mask, dropout_mask, global_batch_rows
from octic_vits_tpu_torch.parallel import mesh as M
from octic_vits_tpu_torch.parallel import sharding as S
from octic_vits_tpu_torch.train.dinov2 import masking
from octic_vits_tpu_torch.train.dinov2.ssl_meta_arch import SSLConfig, SSLMetaArch


@pytest.mark.parametrize("n,fsdp", [(8, 1), (8, 2), (8, 4), (8, 8), (4, 2), (2, 1)])
def test_mesh_layout_is_jax_device_order(n, fsdp):
    jmesh = j_create_mesh(devices=jax.devices()[:n], fsdp=fsdp)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    np.testing.assert_array_equal(M.mesh_layout(n, fsdp), ids)
    assert jmesh.axis_names == (M.DATA_AXIS, M.FSDP_AXIS)


def test_mesh_layout_rejects_what_jax_asserts():
    with pytest.raises(ValueError):
        M.mesh_layout(6, 4)
    with pytest.raises(ValueError):
        M.mesh_layout(4, 0)


def test_hybrid_layout_keeps_fsdp_inside_a_node():
    """torchrun numbers ranks node by node, so the data axis runs node-major
    (JAX's slice-major) and each fsdp group is one node's ranks; an fsdp
    axis that a node does not hold raises (JAX asserts it of a slice)."""
    layout = M.hybrid_mesh_layout(16, 8, fsdp=4)
    np.testing.assert_array_equal(layout, np.arange(16).reshape(4, 4))
    assert all(len(set(row // 8)) == 1 for row in layout)  # one node a group
    np.testing.assert_array_equal(M.hybrid_mesh_layout(8, 8, 2), M.mesh_layout(8, 2))
    with pytest.raises(ValueError, match="one node"):
        M.hybrid_mesh_layout(16, 8, fsdp=16)
    with pytest.raises(ValueError, match="one node"):
        M.hybrid_mesh_layout(12, 4, fsdp=8)
    with pytest.raises(ValueError, match="whole nodes"):
        M.hybrid_mesh_layout(12, 8, fsdp=2)


def _jax_leaves(name):
    jmodel = j_create_model(name, img_size=224 if "huge" in name else 32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *((224, 224) if "huge" in name else (32, 32)), 3)))
    return jax.tree_util.tree_leaves(shapes["params"])


@pytest.fixture(scope="module")
def leaves():
    return {n: _jax_leaves(n) for n in ("hybrid_deit_huge_patch14", "hybrid_vit_small_test")}


@pytest.mark.parametrize("name", ["hybrid_deit_huge_patch14", "hybrid_vit_small_test"])
@pytest.mark.parametrize("fsdp", [2, 4, 8])
def test_leaf_partition_spec_matches_jax(leaves, name, fsdp):
    """The rule on every leaf of the JAX model's tree: the same axis, or
    whole, as JAX's spec on an fsdp axis of that size (the small model's
    leaves all lie under 2**15 elements: there with a bound of 2**8 too)."""
    jmesh = j_create_mesh(devices=jax.devices()[:8], fsdp=fsdp)
    for bound in (2**15,) if "huge" in name else (2**15, 2**8):
        sharded = 0
        for leaf in leaves[name]:
            spec = tuple(j_leaf_partition_spec(leaf.shape, jmesh, min_elements=bound))
            want = spec.index(M.FSDP_AXIS) if M.FSDP_AXIS in spec else None
            assert S.leaf_partition_spec(leaf.shape, fsdp, bound) == want, leaf.shape
            sharded += want is not None
        assert sharded > 0 or bound == 2**15


def test_port_tree_shardings_follow_the_rule():
    """On the port's own ViT-H/14 (meta device): every sharded parameter's
    axis divides by the fsdp size and holds 2**15 elements or more; the
    FSDP2 placement is that axis, or the first for a small tensor."""
    model = create_model("hybrid_deit_huge_patch14", device="meta")
    mesh = types.SimpleNamespace(size=lambda dim: 4)
    rule = S.tree_shardings(model, mesh)
    place = S.shard_placement_fn(mesh)
    params = dict(model.named_parameters())
    assert rule.keys() == params.keys() and any(a is not None for a in rule.values())
    for n, axis in rule.items():
        p = params[n]
        if axis is None:
            assert p.numel() < 2**15 or all(d % 4 for d in p.shape), n
        else:
            assert p.shape[axis] % 4 == 0 and p.numel() >= 2**15, n
        assert place(p).dim == (0 if axis is None else axis)
    assert set(S.replicated_tree(model, mesh).values()) == {None}


def test_batch_shard_blocks():
    shard = M.BatchShard(2, 4)
    x = torch.arange(12)
    assert shard.rows(12) == slice(6, 9) and torch.equal(shard(x), x[6:9])
    assert torch.equal(shard.crop_rows(3), torch.arange(6, 9))
    with pytest.raises(ValueError):
        shard.rows(10)
    assert M.batch_sharding(None) == M.replicated(None) == M.BatchShard()


def test_collectives_are_identities_alone():
    """Without a process group the helpers are one process's."""
    assert not M.distributed() and M.process_count() == 1 and M.process_index() == 0
    t = torch.tensor(3.0)
    assert M.reduce_mean([t]) == [t]
    assert M.any_process(True) is True and M.any_process(False) is False
    assert M.same_on_every_process((1, 2))
    M.barrier()
    with pytest.raises(RuntimeError, match="process group"):
        M.create_mesh()


def test_norms_of_whole_tensors_are_foreach_norm():
    ts = [torch.randn(5, 3), torch.randn(7)]
    want = torch.stack(torch._foreach_norm(ts))
    assert torch.equal(S.norms(ts), want)
    assert torch.equal(S.global_norm(ts), torch.linalg.vector_norm(want))


@pytest.mark.parametrize("world", [2, 4])
def test_global_batch_rows_draw_the_global_masks(world):
    """Inside global_batch_rows each process's masks are its rows of the
    one-process draw, and the generator ends where the one-process draw
    leaves it."""
    total, b = 8, 8 // world
    full_g = torch.Generator().manual_seed(3)
    want_path = drop_path_mask(total, 0.4, full_g)
    want_drop = dropout_mask((total, 5, 6), full_g)
    after = torch.rand(4, generator=full_g)
    for rank in range(world):
        g = torch.Generator().manual_seed(3)
        rows = torch.arange(rank * b, (rank + 1) * b)
        with global_batch_rows(total, rows):
            path = drop_path_mask(b, 0.4, g)
            drop = dropout_mask((b, 5, 6), g)
        assert torch.equal(path, want_path[rank * b:(rank + 1) * b])
        assert torch.equal(drop, want_drop[rank * b:(rank + 1) * b])
        assert torch.equal(torch.rand(4, generator=g), after)
    with pytest.raises(ValueError, match="rows"):
        with global_batch_rows(total, torch.arange(b)):
            drop_path_mask(b + 1, 0.4, torch.Generator())


def test_mixup_partner_is_the_reversed_batch():
    """`partner` row for row the reversed batch gives mixup_cutmix's own."""
    g = torch.Generator().manual_seed(0)
    x, y = torch.randn(6, 8, 8, 3, generator=g), torch.randint(0, 5, (6,), generator=g)
    for cut in (False, True):
        d = MixDraws(True, cut, 0.7, 0.6, 3, 4)
        want = mixup_cutmix(x, y, 5, d, 0.1)
        got = mixup_cutmix(x, y, 5, d, 0.1, partner=(x.flip(0), y.flip(0)))
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("world", [2, 4])
def test_ssl_batch_share(world, monkeypatch):
    """A process's share of a global SSL batch: both global crops and every
    local crop of its images, their masks, and masked-token buffers built
    from those masks alone at the global buffer's length."""
    rng, npr = __import__("random").Random(0), np.random.RandomState(0)
    b = 8
    gen = masking.MaskingGenerator(4, num_masking_patches=8)
    batch = masking.collate_crops_and_masks(npr.randn(2 * b, 4, 4, 3), npr.randn(3 * b, 2, 2, 3),
                                            16, gen, rng=rng)
    arch = SSLMetaArch(SSLConfig(n_local_crops=3), device="cpu")
    mesh = types.SimpleNamespace(mesh=torch.arange(world).reshape(1, world))
    shares = []
    for rank in range(world):
        # this process's position, as a group of `world` would give it
        monkeypatch.setattr(M, "process_index", lambda r=rank: r)
        shares.append(arch.batch_shardings(mesh)(batch))
    k = b // world
    for rank, share in enumerate(shares):
        imgs = [rank * k + i for i in range(k)]
        g_rows = [c * b + i for c in range(2) for i in imgs]
        l_rows = [c * b + i for c in range(3) for i in imgs]
        np.testing.assert_array_equal(M.BatchShard(rank, world).crop_rows(k, 2), g_rows)
        np.testing.assert_array_equal(share["global_crops"], batch["global_crops"][g_rows])
        np.testing.assert_array_equal(share["local_crops"], batch["local_crops"][l_rows])
        np.testing.assert_array_equal(share["masks"], batch["masks"][g_rows])
        want = masking.shard_masked_buffers(batch["masks"][g_rows], len(batch["mask_indices"]))
        for key, v in want.items():
            np.testing.assert_array_equal(share[key], v)
    assert sum(int(s["n_masked_patches"]) for s in shares) == int(batch["n_masked_patches"])


def test_world_from_env():
    assert launch.world_from_env({}) is None
    w = launch.world_from_env({"WORLD_SIZE": "8", "RANK": "5", "LOCAL_RANK": "1",
                               "LOCAL_WORLD_SIZE": "4", "MASTER_ADDR": "node0",
                               "MASTER_PORT": "1234"})
    assert w == launch.World(5, 8, 1, 4, "node0", 1234)
    w = launch.world_from_env({"WORLD_SIZE": "1"})
    assert (w.rank, w.world_size, w.local_rank, w.address) == (0, 1, 0, "localhost")
    with pytest.raises(ValueError):
        launch.world_from_env({"WORLD_SIZE": "2", "RANK": "2"})


def test_backend_follows_the_device():
    assert launch.backend_for("cuda") == "nccl" and launch.backend_for("cuda:1") == "nccl"
    assert launch.backend_for("cpu") == "gloo"
    with pytest.raises(ValueError):
        launch.backend_for("meta")


def test_bootstrap_alone_starts_no_group(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert launch.bootstrap_distributed("cpu") is None
    assert not M.distributed()


def test_bootstrap_on_the_card_without_one_raises():
    """No fallback: a world on the card without a card raises, and no group
    starts on another backend."""
    if torch.cuda.is_available():
        pytest.skip("this checks the failure on a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.bootstrap_distributed(None, environ={"WORLD_SIZE": "2", "RANK": "0"})
    assert not M.distributed()


def test_launcher_dispatches_to_the_module(monkeypatch):
    """main(argv) imports the training module and calls its main with the
    rest of the arguments; --coordinator, --num-processes and --process-id
    override torchrun's environment for the bootstrap."""
    calls, seen = [], []
    fake = types.ModuleType("_fake_training_module")
    fake.main = lambda argv: calls.append(argv) or "done"
    monkeypatch.setitem(sys.modules, "_fake_training_module", fake)

    def bootstrap(device=None, environ=None, world=None):  # noqa: ARG001
        seen.append((device, launch.world_from_env(environ)))
        return None
    monkeypatch.setattr(launch, "bootstrap_distributed", bootstrap)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert launch.main(["_fake_training_module", "--epochs", "2", "--device", "cpu"]) == "done"
    assert calls == [["--epochs", "2", "--device", "cpu"]] and seen[-1] == ("cpu", None)
    launch.main(["_fake_training_module", "--coordinator", "host:99", "--num-processes", "4",
                 "--process-id", "3", "--device=cuda"])
    assert seen[-1] == ("cuda", launch.World(3, 4, 0, 4, "host", 99))
    assert calls[-1] == ["--device=cuda"]


def test_no_kernel_wrapper_caches_by_address():
    """Every cache in the kernel wrappers (ops/) is keyed by shapes, sizes
    and devices, never by a tensor: under ZeRO-3 the parameters are freed
    and gathered again each step, at new addresses."""
    import octic_vits_tpu_torch.ops as ops_pkg

    cached = []
    for info in pkgutil.iter_modules(ops_pkg.__path__):
        mod = importlib.import_module(f"octic_vits_tpu_torch.ops.{info.name}")
        for name, fn in vars(mod).items():
            if callable(fn) and hasattr(fn, "cache_info") and fn.__module__ == mod.__name__:
                cached.append((mod.__name__, name, fn))
    assert cached
    for mod, name, fn in cached:
        for p in inspect.signature(fn.__wrapped__).parameters.values():
            assert "Tensor" not in str(p.annotation), f"{mod}.{name}({p.name})"
            assert p.name not in ("x", "t", "tensor", "weight", "param"), f"{mod}.{name}"


def test_deit_loop_raises_where_the_world_does_not_split_the_batch(monkeypatch, tmp_path):
    """JAX's loop shrinks its mesh until it divides the batch
    (train/deit/main.py:125-130); a process cannot sit idle, so the port
    raises before it builds anything (ROADMAP Queue 3)."""
    from octic_vits_tpu_torch.train.deit import main as deit_main
    from octic_vits_tpu_torch.train.deit.engine import DeiTConfig

    monkeypatch.setattr(deit_main, "process_count", lambda: 3)
    with pytest.raises(ValueError, match="does not split over 3"):
        deit_main.train("hybrid_vit_small_test", DeiTConfig(batch_size=8), [0] * 16, None,
                        str(tmp_path), device="cpu")
