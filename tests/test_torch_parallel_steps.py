"""The port's train steps over 2 and 4 gloo processes on the CPU, held three
ways (f32 both sides):

1. against JAX's step on a CPU mesh of as many devices (the JAX mesh step is
   SPMD over one global batch: the one-device step with its batch split),
   from ``params_from_jax`` weights and the same global batches, randomness
   off: the DeiT III step under DP, ZeRO-2 and ZeRO-3 (LAMB, the clip, the
   EMA), two steps each (the SSL step: tests/test_torch_parallel_ssl_steps.py);
2. against the port's own one-process step on the global batch with mixup,
   cutmix and drop path on, from one generator;
3. mixup alone against JAX's ``mixup_cutmix`` on the global batch with the
   same draws; and the cross-process arithmetic on its own: LAMB's trust
   ratio and the global norm of ZeRO-3 shards, the centre and Sinkhorn-Knopp
   sums, KoLeo per device.

Each group of processes is started once a module (``tests/torch_dist.py``,
spawn, a ``FileStore``) under the suite's time limit. Tolerance 1e-5 unless
a test says otherwise."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from octic_vits_tpu.data.mixup import mixup_cutmix as j_mixup_cutmix
from octic_vits_tpu.models.registry import create_model as j_create_model
from octic_vits_tpu.parallel import batch_sharding as j_batch_sharding
from octic_vits_tpu.parallel import create_mesh as j_create_mesh
from octic_vits_tpu.train.common import create_train_state as j_create_state
from octic_vits_tpu.train.common import state_shardings as j_state_shardings
from octic_vits_tpu.train.deit import engine as jengine
from octic_vits_tpu.train.dinov2 import losses as JL
from octic_vits_tpu_torch import create_model
from octic_vits_tpu_torch.train.dinov2 import losses as L
from octic_vits_tpu_torch.utils.convert import params_from_jax

import torch_dist
from torch_time_limit import alarm

torch.set_num_threads(1)
ATOL = RTOL = 1e-5
WORLDS = (2, 4)


def _close(ours, theirs, atol=ATOL, rtol=RTOL, msg=""):
    if isinstance(ours, torch.Tensor):
        ours = ours.detach().numpy()
    np.testing.assert_allclose(ours, np.asarray(theirs), atol=atol, rtol=rtol, err_msg=msg)


def _perturbed(tree, seed, scale=0.02):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(a.shape).astype(np.float32), tree)


def _jax_draws(key, h, w, mixup_alpha=0.8, cutmix_alpha=1.0, prob=0.8, switch_prob=0.5):
    """The draws JAX's mixup_cutmix makes from `key` (its own key splits)."""
    from octic_vits_tpu_torch.data.mixup import MixDraws

    k_apply, k_switch, k_lam_m, k_lam_c, k_box = jax.random.split(key, 5)
    ky, kx = jax.random.split(k_box)
    return MixDraws(apply=bool(jax.random.bernoulli(k_apply, prob)),
                    use_cutmix=bool(jax.random.bernoulli(k_switch, switch_prob)),
                    lam_mix=float(jax.random.beta(k_lam_m, mixup_alpha, mixup_alpha)),
                    lam_cut=float(jax.random.beta(k_lam_c, cutmix_alpha, cutmix_alpha)),
                    cy=int(jax.random.randint(ky, (), 0, h)),
                    cx=int(jax.random.randint(kx, (), 0, w)))


# ---- the DeiT III step -----------------------------------------------------------------

# the recipe's LAMB, clip 1.0, EMA and BCE; deterministic
DEIT_CFG = dict(num_classes=10, mixup_alpha=0.0, cutmix_alpha=0.0, drop_path=0.0,
                warmup_epochs=0, epochs=10, steps_per_epoch=10, lr=1e-3)
# (layout, fsdp): DP, ZeRO-2 and ZeRO-3 over every process; at 4 processes
# also ZeRO-3 on a (2, 2) mesh, FSDP2's HSDP
LAYOUTS = {2: [("dp", 1), ("zero2", 2), ("zero3", 2)],
           4: [("dp", 1), ("zero2", 4), ("zero3", 4), ("zero3", 2)]}
RANDOM_CFG = dict(num_classes=10, warmup_epochs=0, epochs=10, steps_per_epoch=10, lr=1e-3,
                  mixup_prob=1.0)


def _jax_deit(params, batches, world, fsdp, shard_params):
    """JAX's DeiT loop wiring (train/deit/main.py:124-161) on `world` CPU
    devices: the state laid out by state_shardings, the batches by
    batch_sharding."""
    jmodel = j_create_model("hybrid_vit_small_test", img_size=torch_dist.DEIT_IMG,
                            drop_path_rate=0.0)
    jcfg = jengine.DeiTConfig(**DEIT_CFG)
    tx = jengine.build_optimizer(jcfg, params)
    state = j_create_state(jax.tree_util.tree_map(jnp.asarray, params), tx, ema=True)
    mesh = j_create_mesh(devices=jax.devices()[:world], fsdp=fsdp)
    state = jax.device_put(state, j_state_shardings(state, mesh, shard_params=shard_params))
    step = jax.jit(jengine.make_deit_train_step(jmodel, jcfg, tx), donate_argnums=(0,))
    data = j_batch_sharding(mesh)
    metrics = []
    for images, labels in batches:
        state, m = step(state, jax.device_put(jnp.asarray(images), data),
                        jax.device_put(jnp.asarray(labels.astype(np.int32)), data),
                        jax.random.PRNGKey(0))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.device_get(state.params), jax.device_get(state.ema_params)


def _deit_group(world, tmp):
    """One group of `world` processes: every layout's two deterministic
    steps from JAX's weights, and the DP and ZeRO-3 steps with mixup, cutmix
    and drop path on; the one-process port step of the latter here."""
    jmodel = j_create_model("hybrid_vit_small_test", img_size=torch_dist.DEIT_IMG,
                            drop_path_rate=0.0)
    params = _perturbed(jmodel.init(jax.random.PRNGKey(3), jnp.zeros(
        (1, torch_dist.DEIT_IMG, torch_dist.DEIT_IMG, 3)))["params"], 3)
    tmodel = create_model("hybrid_vit_small_test", img_size=torch_dist.DEIT_IMG, device="cpu")
    sd = params_from_jax({"params": params}, tmodel)
    jax_case = dict(cfg=DEIT_CFG, sd=sd, batches=torch_dist.deit_batches(5),
                    layouts=LAYOUTS[world])
    random_case = dict(cfg=RANDOM_CFG, modes=("dp", "zero3"), drop_path=0.3,
                       batches=torch_dist.deit_batches(6), generators=(11, 12))
    with alarm():
        out = torch_dist.run_processes(torch_dist.deit_worker, world, tmp, jax_case, random_case)
    one = torch_dist.deit_run("one", RANDOM_CFG, None, random_case["batches"],
                              random_case["generators"], random_case["drop_path"])
    one_accum = torch_dist.deit_run("one", dict(RANDOM_CFG, accum_steps=2), None,
                                    random_case["batches"], random_case["generators"],
                                    random_case["drop_path"])
    return dict(world=world, params=params, tmodel=tmodel, jax_case=jax_case, ranks=out, one=one,
                one_accum=one_accum)


@pytest.fixture(scope="module")
def deit_groups(tmp_path_factory):
    """world -> its group, started once a module."""
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = _deit_group(world, tmp_path_factory.mktemp(f"deit{world}"))
        return cache[world]
    return get


@pytest.mark.parametrize("world,mode,fsdp", [(w, m, f) for w in WORLDS for m, f in LAYOUTS[w]],
                         ids=[f"world{w}-{m}-fsdp{f}" for w in WORLDS for m, f in LAYOUTS[w]])
def test_deit_step_matches_jax_mesh(deit_groups, world, mode, fsdp):
    deit_group = deit_groups(world)
    jm, jparams, jema = _jax_deit(deit_group["params"], deit_group["jax_case"]["batches"],
                                  world, fsdp, mode == "zero3")
    tmodel = deit_group["tmodel"]
    new = params_from_jax({"params": jparams}, tmodel)
    ema = params_from_jax({"params": jema}, tmodel)
    old = deit_group["jax_case"]["sd"]
    for rank, out in enumerate(deit_group["ranks"]):
        got = out[("jax", mode, fsdp)]
        for i, (ours, theirs) in enumerate(zip(got["metrics"], jm)):
            for k in ("loss", "grad_norm"):
                _close(ours[k], theirs[k], msg=f"rank {rank} step {i} {k}")
        for name in new:
            _close(got["params"][name], new[name], msg=f"rank {rank} {name}")
            _close(got["ema"][name], ema[name], msg=f"rank {rank} ema {name}")
    moved = max((deit_group["ranks"][0][("jax", mode, fsdp)]["params"][n] - old[n]).abs().max()
                for n in old)
    assert moved > 1e-4  # two updates, visible above the tolerance


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode", ["dp", "zero3"])
def test_deit_step_with_randomness_matches_one_process(deit_groups, world, mode):
    """Mixup, cutmix (global row i with row B-1-i, across processes) and drop
    path (the global batch's draws, each process its rows) on: the N-process
    step is the one-process step on the global batch."""
    deit_group = deit_groups(world)
    one = deit_group["one"]
    for rank, out in enumerate(deit_group["ranks"]):
        got = out[("random", mode)]
        for i, (ours, theirs) in enumerate(zip(got["metrics"], one["metrics"])):
            for k in ("loss", "grad_norm"):
                _close(ours[k], theirs[k], msg=f"rank {rank} step {i} {k}")
        for name, p in one["params"].items():
            _close(got["params"][name], p, msg=f"rank {rank} {name}")
            _close(got["ema"][name], one["ema"][name], msg=f"rank {rank} ema {name}")
            _close(got["mu"][name], one["mu"][name], atol=1e-7, rtol=1e-4,
                   msg=f"rank {rank} moment {name}")


@pytest.mark.parametrize("world", WORLDS)
def test_deit_accumulation_microbatches_are_per_process(deit_groups, world):
    """With accum_steps=2 a process's microbatch i is its own i-th chunk,
    where the one-process step's is a contiguous block of the global batch:
    the drop-path rows fall elsewhere, so the steps differ (ROADMAP Queue 3);
    every process still takes the same update."""
    g = deit_groups(world)
    one = g["one_accum"]["metrics"][0]["loss"]
    losses = [r[("accum", "dp")]["metrics"][0]["loss"] for r in g["ranks"]]
    assert len(set(losses)) == 1 and abs(losses[0] - one) > 1e-4
    first = g["ranks"][0][("accum", "dp")]["params"]
    for r in g["ranks"][1:]:
        for name, p in r[("accum", "dp")]["params"].items():
            assert torch.equal(p, first[name]), name


# ---- mixup, LAMB, norms and the SSL sums, each across processes ---------------------------


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def small_group(request, tmp_path_factory):
    """One group of `world` processes for the mixup, LAMB, norm and
    centring cases."""
    world = request.param
    rng = np.random.default_rng(20 + world)
    images = rng.standard_normal((8, 16, 12, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=8).astype(np.int64)
    keys = [jax.random.PRNGKey(s) for s in range(8)]
    cases = [(_jax_draws(k, 16, 12), 0.1 * (s % 2)) for s, k in enumerate(keys)]
    weights = {"w0": rng.standard_normal((256, 192)).astype(np.float32),   # sharded on axis 0
               "w1": rng.standard_normal((96, 512)).astype(np.float32),    # on axis 1
               "b": rng.standard_normal(5).astype(np.float32)}             # small: axis 0, padded
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in weights.items()}
             for _ in range(2)]
    logits = rng.standard_normal((16, 24)).astype(np.float32) * 3
    mask = (rng.random(16) < 0.6).astype(np.float32)
    with alarm():
        out = torch_dist.run_processes(torch_dist.small_worker, world,
                                       tmp_path_factory.mktemp("small"),
                                       (images, labels, cases), (weights, grads),
                                       (logits, mask, 0.07))
    return dict(world=world, images=images, labels=labels, keys=keys, cases=cases,
                weights=weights, grads=grads, logits=logits, mask=mask,
                mixed=[r["mixup"] for r in out], lamb=[r["lamb"] for r in out],
                centre=[r["centre"] for r in out])


def test_mixup_across_processes_matches_jax(small_group):
    """Each process's block of the mixed batch and targets, concatenated,
    is JAX's mixup_cutmix of the global batch with the same draws (both
    branches: the 8 keys draw mixup and cutmix)."""
    g = small_group
    kinds = set()
    for i, (key, (draws, smoothing)) in enumerate(zip(g["keys"], g["cases"])):
        jm, jt = j_mixup_cutmix(key, jnp.asarray(g["images"]), jnp.asarray(g["labels"]), 10,
                                0.8, 1.0, 0.8, 0.5, smoothing)
        tm = torch.cat([r[i][0] for r in g["mixed"]])
        tt = torch.cat([r[i][1] for r in g["mixed"]])
        _close(tm, jm, atol=1e-6, rtol=1e-6, msg=f"images {i}")
        _close(tt, jt, atol=1e-6, rtol=1e-6, msg=f"targets {i}")
        kinds.add(("none" if not draws.apply else "cutmix" if draws.use_cutmix else "mixup"))
    assert {"mixup", "cutmix"} <= kinds


def test_lamb_trust_ratio_under_zero3_is_the_whole_tensors(small_group):
    """LAMB on ZeRO-3 shards (axis 0, axis 1 and a padded small tensor) is
    LAMB on the whole tensors in one process; a ratio from each shard's own
    norms is not, so the test can tell the two apart."""
    from octic_vits_tpu_torch.train.optim import Lamb

    g = small_group
    ts = {k: torch.from_numpy(v.copy()) for k, v in g["weights"].items()}
    opt = Lamb([{"params": list(ts.values()), "weight_decay": 0.05}], lr=1e-2, betas=(0.9, 0.99),
               eps=1e-8)
    for grads in g["grads"]:
        for k, t in ts.items():
            t.grad = torch.from_numpy(grads[k])
        opt.step()
    for rank, out in enumerate(g["lamb"]):
        for k, t in ts.items():
            _close(out["params"][k], t, atol=1e-6, rtol=1e-6, msg=f"rank {rank} {k}")
        worst = max((out["per_shard"][k] - ts[k]).abs().max().item() for k in ts)
        assert worst > 1e-4, "a per-shard trust ratio went unnoticed"


def test_global_norm_of_zero3_gradients(small_group):
    g = small_group
    want = np.sqrt(sum(float(np.square(v.astype(np.float64)).sum())
                       for v in g["grads"][-1].values()))
    for out in g["lamb"]:
        assert out["grad_norm"] == pytest.approx(want, rel=1e-6)


def test_centre_and_sinkhorn_sum_over_processes(small_group):
    """The centre update and Sinkhorn-Knopp of each process's rows with the
    group's sums are JAX's of the global batch, weighted and not."""
    g = small_group
    t, w = jnp.asarray(g["logits"]), jnp.asarray(g["mask"] > 0)
    zero = JL.CenterState(jnp.zeros(t.shape[1]))
    want = {"center": JL.update_center(zero, t, 0.9).center,
            "center_w": JL.update_center(zero, t, 0.9, weights=w).center,
            "sk": JL.sinkhorn_knopp_teacher(t, 0.07),
            "sk_w": JL.sinkhorn_knopp_teacher(t, 0.07, sample_mask=w)}
    for rank, out in enumerate(g["centre"]):
        for k in ("center", "center_w"):
            _close(out[k], want[k], msg=f"rank {rank} {k}")
    for k in ("sk", "sk_w"):
        _close(torch.cat([out[k] for out in g["centre"]]), want[k], msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_koleo_per_device_matches_jax(world):
    """The mean over processes of each one's KoLeo is JAX's
    koleo_loss_per_device on a mesh of as many devices."""
    rng = np.random.default_rng(30 + world)
    cls = rng.standard_normal((4 * world, 16)).astype(np.float32)
    mesh = j_create_mesh(devices=jax.devices()[:world])
    want = float(JL.koleo_loss_per_device(jnp.asarray(cls), mesh))
    ours = np.mean([float(L.koleo_loss_per_device(torch.from_numpy(block)))
                    for block in np.split(cls, world)])
    assert ours == pytest.approx(want, rel=1e-5)
    assert abs(float(JL.koleo_loss(jnp.asarray(cls))) - want) > 1e-3  # per device is not global
