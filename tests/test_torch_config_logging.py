"""Parity of the port's config system and metric logging with the JAX
package on the CPU: ``build_config`` (default <- file <- dotlist, ``${ENV}``
interpolation), ``write_config``, the port's own YAML copies (byte-equal to
the JAX package's), SmoothedValue, MetricLogger's lines and its
``log_every`` timing generator, and the wandb shims; and that importing the
port needs neither PIL nor PyYAML."""

import filecmp
import json
import os
import subprocess
import sys

import pytest

from octic_vits_tpu.utils import config as jconfig
from octic_vits_tpu.utils import logging as jlogging
from octic_vits_tpu_torch.utils import config as tconfig
from octic_vits_tpu_torch.utils import logging as tlogging

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CONFIGS = os.path.join(REPO, "octic_vits_tpu", "configs")


def _yaml_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root)
                  for f in fs if f.endswith(".yaml"))


def test_config_copies_are_byte_equal():
    """The port reads its own copies (octic_vits_tpu_torch/configs), never
    the JAX package's files; the copies stay byte-equal to them."""
    ours = _yaml_files(tconfig.CONFIG_DIR)
    assert ours == _yaml_files(JAX_CONFIGS) and len(ours) == 13
    for rel in ours:
        assert filecmp.cmp(os.path.join(tconfig.CONFIG_DIR, rel), os.path.join(JAX_CONFIGS, rel),
                           shallow=False), rel
    assert tconfig.CONFIG_DIR.startswith(os.path.join(REPO, "octic_vits_tpu_torch"))


OPTS = [[], ["optim.lr=0.004", "train.batch_size_per_gpu=32"],
        ["student.arch=hybrid_dinov2_vit_large_patch16", "new.section.key=[1, 2]",
         "crops.local_crops_number=2", "train.dataset_path=ImageFolder:root=${OCTIC_TEST_ROOT}"],
        ["ibot.separate_head=true", "optim.epochs=1e1", "train.output_dir=null"]]


@pytest.mark.parametrize("opts", OPTS, ids=["none", "numbers", "env_and_new_keys", "types"])
@pytest.mark.parametrize("config_file", ["", "train/hybrid_vitl16.yaml", "eval/vith16.yaml"])
def test_build_config_matches_jax(monkeypatch, opts, config_file):
    monkeypatch.setenv("OCTIC_TEST_ROOT", "/data/in1k")
    monkeypatch.setenv("IMAGENET_PATH", "/data/imagenet")
    monkeypatch.delenv("EXTRA_PATH", raising=False)
    default = tconfig.load_yaml(os.path.join(tconfig.CONFIG_DIR, "ssl_default_config.yaml"))
    assert default == jconfig.load_yaml(os.path.join(JAX_CONFIGS, "ssl_default_config.yaml"))
    ours = tconfig.build_config(default, config_file and os.path.join(tconfig.CONFIG_DIR,
                                                                      config_file), list(opts))
    theirs = jconfig.build_config(default, config_file and os.path.join(JAX_CONFIGS, config_file),
                                  list(opts))
    assert ours.to_dict() == theirs.to_dict()
    assert isinstance(ours.train, tconfig.ConfigNode) and ours.train.seed == 0
    assert ours.train.dataset_path == theirs.train.dataset_path
    with pytest.raises(AttributeError):
        ours.no_such_section


def test_env_interpolation_and_write_config(tmp_path, monkeypatch):
    monkeypatch.setenv("A_PATH", "/a")
    monkeypatch.delenv("B_PATH", raising=False)
    tree = {"x": "${A_PATH}/y:${B_PATH}", "n": {"k": 3, "s": "${A_PATH}"}}
    ours = tconfig.build_config(tree, None, ["n.t=${A_PATH}/t"])
    assert ours.to_dict() == jconfig.build_config(tree, None, ["n.t=${A_PATH}/t"]).to_dict()
    assert ours.x == "/a/y:" and ours.n.t == "/a/t"
    p1 = tconfig.write_config(ours, str(tmp_path / "ours"))
    p2 = jconfig.write_config(jconfig.ConfigNode.from_dict(ours.to_dict()), str(tmp_path / "jax"))
    assert open(p1).read() == open(p2).read()
    assert tconfig.load_yaml(p1) == ours.to_dict()


def test_smoothed_value_matches_jax():
    ours, theirs = tlogging.SmoothedValue(window_size=4), jlogging.SmoothedValue(window_size=4)
    for i, v in enumerate([3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0]):
        ours.update(v, n=1 + i % 2)
        theirs.update(v, n=1 + i % 2)
        for attr in ("median", "avg", "global_avg", "max", "value"):
            assert getattr(ours, attr) == getattr(theirs, attr), attr
        assert str(ours) == str(theirs)


def test_metric_logger_lines_match_jax(tmp_path, capsys):
    outs = []
    for mod, name in ((tlogging, "ours.json"), (jlogging, "jax.json")):
        logger = mod.MetricLogger(output_file=str(tmp_path / name))
        seen = []
        for i in logger.log_every(range(7), 3, header="Epoch 0"):
            logger.update(loss=1.0 / (i + 1), acc=i)
            seen.append(i)
        logger.dump_in_output_file(99, 0.5, 0.25)
        assert seen == list(range(7))
        lines = [json.loads(x) for x in open(tmp_path / name).read().splitlines()]
        outs.append((str(logger), lines, capsys.readouterr().out))
    (s1, l1, p1), (s2, l2, p2) = outs
    assert s1 == s2
    assert [(x["iteration"], x.get("loss"), x.get("acc")) for x in l1] == [
        (x["iteration"], x.get("loss"), x.get("acc")) for x in l2]
    # iterations 0, 3, 6 (and the last, 6) are dumped, then the explicit line
    assert [x["iteration"] for x in l1] == [0, 3, 6, 99] and l1[-1]["iter_time"] == 0.5
    assert p1.count("Epoch 0") == p2.count("Epoch 0") == 3
    assert tlogging.MetricLogger().dump_in_output_file(0, 0.0, 0.0) is None  # no file: no-op


def test_log_every_stops_at_n_iterations():
    logger = tlogging.MetricLogger()
    seen = list(logger.log_every(iter(range(100)), 1000, n_iterations=5, start_iteration=2))
    assert seen == [0, 1, 2, 3, 4]


def test_wandb_shims_are_noops_without_config(monkeypatch):
    monkeypatch.delenv("WANDB_ENTITY", raising=False)
    monkeypatch.delenv("WANDB_PROJECT", raising=False)
    assert tlogging.maybe_wandb_init("p", {"a": 1}) is None
    tlogging.maybe_wandb_log({"loss": 1.0}, step=0)  # nothing to log to: no error


def test_import_needs_neither_pil_nor_yaml():
    """`import octic_vits_tpu_torch` and every module of the loops import with
    PIL and PyYAML blocked (they are imported where an image is decoded or a
    YAML file parsed)."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('PIL', 'yaml'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import octic_vits_tpu_torch\n"
        "import octic_vits_tpu_torch.data.datasets, octic_vits_tpu_torch.data.loaders\n"
        "import octic_vits_tpu_torch.data.native, octic_vits_tpu_torch.data.samplers\n"
        "import octic_vits_tpu_torch.data.transforms, octic_vits_tpu_torch.utils.config\n"
        "import octic_vits_tpu_torch.utils.logging, octic_vits_tpu_torch.utils.checkpoint\n"
        "import octic_vits_tpu_torch.utils.finetune, octic_vits_tpu_torch.hub\n"
        "import octic_vits_tpu_torch.train.deit.main, octic_vits_tpu_torch.train.deit.cli\n"
        "import octic_vits_tpu_torch.train.dinov2.train, octic_vits_tpu_torch.train.dinov2.cli\n"
        "try:\n"
        "    import yaml\n"
        "except ImportError:\n"
        "    pass\n"
        "else:\n"
        "    raise SystemExit('the blocker let yaml through')\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]
