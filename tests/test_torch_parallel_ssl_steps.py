"""The port's DINOv2 SSL step over 2 and 4 gloo processes on the CPU against
JAX's SSL mesh step on a CPU mesh of as many devices (f32 both sides), from
``params_from_jax`` weights and the same global batches (each process takes
its images' crops, masks and masked-token buffers:
``SSLMetaArch.batch_shardings``), two steps, randomness off: DP, ZeRO-2 and
ZeRO-3, the centring and Sinkhorn-Knopp sums over the processes, KoLeo per
device or over the gathered global batch (``koleo_global``) and the iBOT
loss over the processes' own masked counts. Each group
of processes is started once a module (``tests/torch_dist.py``, spawn, a
``FileStore``) under the suite's time limit."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from octic_vits_tpu.models import OcticDinoVisionTransformer as JOcticDino
from octic_vits_tpu.models.registry import register_model as j_register_model
from octic_vits_tpu.parallel import create_mesh as j_create_mesh
from octic_vits_tpu.train.dinov2.ssl_meta_arch import SSLConfig as JSSLConfig
from octic_vits_tpu.train.dinov2.ssl_meta_arch import SSLMetaArch as JSSLMetaArch
from octic_vits_tpu.train.dinov2.ssl_meta_arch import SSLState as JSSLState
from octic_vits_tpu_torch.train.dinov2.ssl_meta_arch import SSLConfig, SSLMetaArch
from octic_vits_tpu_torch.utils.convert import params_from_jax

import torch_dist
from torch_time_limit import alarm

torch.set_num_threads(1)
ATOL = RTOL = 1e-5


def _close(ours, theirs, atol=ATOL, rtol=RTOL, msg=""):
    if isinstance(ours, torch.Tensor):
        ours = ours.detach().numpy()
    np.testing.assert_allclose(ours, np.asarray(theirs), atol=atol, rtol=rtol, err_msg=msg)


def _perturbed(tree, seed, scale=0.02):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(a.shape).astype(np.float32), tree)


@j_register_model
def hybrid_dinov2_vit_tiny_test(img_size=32, **kwargs):
    """The JAX twin of the port's registry entry of the same name."""
    kwargs.setdefault("drop_path_rate", 0.0)
    return JOcticDino(img_size=img_size, patch_size=8, embed_dim=32, depth=2, num_heads=2,
                      mlp_ratio=2.0, **kwargs)


SINKHORN = dict(centering="sinkhorn_knopp", ibot_separate_head=True)
# name: (world, layout, config overrides). DP (the loop's layout), ZeRO-2 and
# ZeRO-3, both centerings (Sinkhorn-Knopp with the separate iBOT head), KoLeo
# per device in each but the two global ones (the gather's gradient under DDP
# and under FSDP2)
SSL_CASES = {"w2_dp_centering": (2, "dp", {}),
             "w2_zero2_centering": (2, "zero2", {}),
             "w2_zero3_sinkhorn": (2, "zero3", SINKHORN),
             "w4_zero2_sinkhorn": (4, "zero2", SINKHORN),
             "w4_zero3_centering": (4, "zero3", {}),
             "w2_dp_koleo_global": (2, "dp", {"koleo_global": True}),
             "w4_zero2_koleo_global": (4, "zero2", {"koleo_global": True})}


def _ssl_params(extra):
    jarch = JSSLMetaArch(JSSLConfig(**torch_dist.SSL_CFG, **extra, compute_dtype=jnp.float32))
    return jarch, _perturbed(jax.jit(jarch.init)(jax.random.PRNGKey(0)).student, 80)


def _student(extra):
    return SSLMetaArch(SSLConfig(**torch_dist.SSL_CFG, **extra, compute_dtype=None),
                       device="cpu").build_student()


def _ssl_group(world, tmp):
    cases = {n: (mode, extra) for n, (w, mode, extra) in SSL_CASES.items() if w == world}
    sds = {n: params_from_jax({"params": _ssl_params(extra)[1]}, _student(extra))
           for n, (_, extra) in cases.items()}
    batches = torch_dist.ssl_batches(7)
    with alarm():
        out = torch_dist.run_processes(torch_dist.ssl_worker, world, tmp, cases, sds, batches)
    return dict(sds=sds, batches=batches, ranks=out)


@pytest.fixture(scope="module")
def ssl_groups(tmp_path_factory):
    """world -> its group, started once a module."""
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = _ssl_group(world, tmp_path_factory.mktemp(f"ssl{world}"))
        return cache[world]
    return get


def _jax_ssl(extra, world, mode, batches):
    """JAX's SSL loop wiring (train/dinov2/train.py:125-145) on `world` CPU
    devices: state_shardings, batch_shardings, make_train_step(mesh)."""
    jarch, params = _ssl_params(extra)
    fresh = lambda f: jax.tree_util.tree_map(f, params)  # noqa: E731  (the step donates)
    jstate = JSSLState(step=jnp.zeros((), jnp.int32), student=fresh(jnp.asarray),
                       teacher=fresh(jnp.asarray), mu=fresh(jnp.zeros_like),
                       nu=fresh(jnp.zeros_like), dino_center=jnp.zeros(64),
                       ibot_center=jnp.zeros(64))
    mesh = j_create_mesh(devices=jax.devices()[:world], fsdp=1 if mode == "dp" else world)
    state_sh = jarch.state_shardings(jstate, mesh, shard_params=mode == "zero3")
    jstate = jax.device_put(jstate, state_sh)
    step = jarch.make_train_step(mesh=mesh, state_sh=state_sh)
    batch_sh = jarch.batch_shardings(mesh)
    metrics, mu = [], []
    for batch in batches:
        jb = {k: jax.device_put(jnp.asarray(v), batch_sh[k]) for k, v in batch.items()}
        jstate, m = step(jstate, jb, torch_dist.SSL_SCHED, jax.random.PRNGKey(1))
        metrics.append({k: float(v) for k, v in m.items()})
        mu.append(jax.device_get(jstate.mu))
    return metrics, jax.device_get(jstate), mu


@pytest.mark.parametrize("case", sorted(SSL_CASES))
def test_ssl_step_matches_jax_mesh(ssl_groups, case):
    """Two SSL steps against JAX's mesh step: the losses and gradient norms,
    the first moments after each step (linear in the gradients; the first
    at atol 1e-7 and rtol 1e-4, a tenth of the one-process test's gradient
    bar, the second ten times that) and the centres at 1e-5; the student
    and teacher as the one-process SSL test holds them: AdamW's early steps
    move a parameter by about lr * sign(m), the sign of f32 noise where a
    gradient is zero, so an entry whose first moment was noise-sized after
    either step may differ by up to 2 lr (two steps), and every other entry
    agrees within 1e-2 lr."""
    world, mode, extra = SSL_CASES[case]
    group = ssl_groups(world)
    jmetrics, jstate, jmu = _jax_ssl(extra, world, mode, group["batches"])
    student = _student(extra)
    new = params_from_jax({"params": jstate.student}, student)
    teacher = params_from_jax({"params": jstate.teacher}, student)
    mus = [params_from_jax({"params": m}, student) for m in jmu]
    old = group["sds"][case]
    lr = torch_dist.SSL_SCHED["lr"]
    for rank, ranks in enumerate(group["ranks"]):
        got = ranks[case]
        for i, (ours, theirs) in enumerate(zip(got["metrics"], jmetrics)):
            assert ours.keys() == theirs.keys()
            for k in theirs:
                _close(ours[k], theirs[k], msg=f"rank {rank} step {i} {k}")
        _close(got["dino_center"], jstate.dino_center, msg="dino center")
        _close(got["ibot_center"], jstate.ibot_center, msg="ibot center")
        n_noise = n_total = 0
        for name in new:
            well = np.ones(new[name].shape, bool)
            for i, mu in enumerate(mus):
                # the second step's gradients are taken at parameters that
                # the first step's noise-sized entries moved apart
                _close(got["mu"][i][name], mu[name], atol=1e-7 * 10 ** i, rtol=1e-4 * 10 ** i,
                       msg=f"rank {rank} step {i} mu {name}")
                well &= np.abs(mu[name].numpy()) >= 1e-7
            n_noise += int((~well).sum())
            n_total += well.size
            for ours, theirs, tag in ((got["student"][name], new[name], ""),
                                      (got["teacher"][name], teacher[name], "teacher ")):
                diff = np.abs(ours.numpy() - theirs.numpy())
                assert diff[well].max(initial=0.0) <= 1e-2 * lr, f"rank {rank} {tag}{name}"
                assert diff.max() <= 2 * lr, f"rank {rank} {tag}{name}"
        assert n_noise < 0.05 * n_total
        moved = max((got["student"][n] - old[n]).abs().max().item() for n in old)
        assert moved > 1e-4


def test_koleo_global_one_process_is_koleo_loss():
    """Without a process group ``koleo_global`` is ``koleo_loss``: two SSL
    steps of the port with and without it are bitwise equal."""
    sd = params_from_jax({"params": _ssl_params({})[1]}, _student({}))
    batches = torch_dist.ssl_batches(8)
    runs = [torch_dist.ssl_run("one", extra, sd, batches) for extra in ({}, {"koleo_global": True})]
    assert torch_dist.tree_equal(runs[0], runs[1])
    assert runs[0]["metrics"][0]["koleo_loss"] != 0.0
