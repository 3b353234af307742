"""Checkpointing of the port: keep-N rotating train-state checkpoints saved
in the background, teacher-only exports for the eval paths, and a
preemption guard (counterpart of octic_vits_tpu/utils/checkpoint.py).

The format is the port's own. A checkpoint is a directory holding one
``torch.save`` file per top-level entry of the state (``<key>.pt``) and a
``meta.json`` that names the format and the keys; it is written under a
temporary name beside its final one and renamed into place, so a reader
finds a whole checkpoint or none. The JAX package's orbax checkpoints cannot
be read without JAX, and :func:`load_tree` refuses them.

Orbax saves from an immutable state while the next step runs. The port's
steps update their tensors in place, so :meth:`CheckpointManager.save` first
copies the state to host memory (:func:`to_host`), in the caller's thread,
and only the writing runs in the background: the checkpoint holds the state
of the step it names, whatever the loop does next.

Under a process group the checkpoint holds whole tensors: :func:`to_host`
gathers each sharded tensor (a collective that every process takes, in the
same order), process 0 alone keeps the copy and writes it, and the others
wait on a barrier for the write to end before they go on, so that every
process reads back what was written; every process restores. The files are
those of a one-process run: the hub and a resume in one process read them.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import signal
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import torch

from octic_vits_tpu_torch.parallel.mesh import barrier, process_index
from octic_vits_tpu_torch.parallel.sharding import full

FORMAT = "octic_vits_tpu_torch/1"
_META = "meta.json"
_KEY = re.compile(r"[A-Za-z0-9_]+")


def to_host(tree: Any, keep: bool = True) -> Any:
    """A copy of `tree` in host memory: every tensor copied to the CPU into
    storage of its own (a sharded one gathered whole first), every dict,
    list and tuple rebuilt, other leaves (ints, floats, strings) as they
    are. With ``keep=False`` the sharded tensors are still gathered, as the
    other processes need, and None is returned: a process that writes
    nothing keeps no copy."""
    out = _host_copy(tree, keep)
    return out if keep else None


def _host_copy(tree: Any, keep: bool) -> Any:
    if isinstance(tree, torch.Tensor):
        whole = full(tree.detach())
        return whole.to("cpu", copy=True) if keep else None
    if isinstance(tree, dict):
        return {k: _host_copy(v, keep) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v, keep) for v in tree)
    return tree


def is_checkpoint(path: str) -> bool:
    """Whether `path` is a directory written by :func:`save_tree`."""
    meta = os.path.join(path, _META)
    if not os.path.isfile(meta):
        return False
    with open(meta) as f:
        return json.load(f).get("format") == FORMAT


def save_tree(path: str, tree: Dict[str, Any]) -> str:
    """Write `tree` (top-level keys of letters, digits and underscores) as
    the checkpoint directory `path`, replacing one that is there. Returns
    the absolute path."""
    path = os.path.abspath(path)
    bad = [k for k in tree if not (isinstance(k, str) and _KEY.fullmatch(k))]
    if bad:
        raise ValueError(f"checkpoint keys must be names of letters, digits and _: {bad}")
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".{os.path.basename(path)}.tmp-", dir=parent)
    try:
        for key, value in tree.items():
            torch.save(value, os.path.join(tmp, f"{key}.pt"))
        with open(os.path.join(tmp, _META), "w") as f:
            json.dump({"format": FORMAT, "keys": list(tree)}, f)
        if os.path.exists(path):  # a newer export of the same name
            old = tmp + ".old"
            os.replace(path, old)
            os.replace(tmp, path)
            shutil.rmtree(old)
        else:
            os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def load_tree(path: str) -> Dict[str, Any]:
    """Read a checkpoint directory into a tree of CPU tensors (memory-mapped
    from its files). A directory of another format raises
    ``NotImplementedError``: the port reads only its own."""
    path = os.path.abspath(path)
    meta_path = os.path.join(path, _META)
    if not os.path.isfile(meta_path):
        raise NotImplementedError(
            f"{path} is not a checkpoint of octic_vits_tpu_torch (no {_META}): the port reads "
            f"only its own format, a directory of torch.save files; an orbax checkpoint of the "
            f"JAX package needs JAX to read")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path}: checkpoint format {meta.get('format')!r}, expected {FORMAT!r}")
    return {key: torch.load(os.path.join(path, f"{key}.pt"), map_location="cpu",
                            weights_only=True, mmap=True) for key in meta["keys"]}


def backbone_state_dict(tree: Dict[str, Any], checkpoint_key: str = "teacher") -> Dict[str, Any]:
    """The backbone's state_dict in a tree of :func:`load_tree`: the
    `checkpoint_key` entry, else 'model' (a DeiT state or ``best`` export),
    else 'teacher' (an SSL state), else the whole tree (a teacher export); of
    a DINOv2 teacher its ``backbone`` part (nested in an export, a
    ``backbone.`` prefix in a state)."""
    sd = next((tree[k] for k in (checkpoint_key, "model", "teacher")
               if isinstance(tree.get(k), dict)), tree)
    if isinstance(sd.get("backbone"), dict):
        return sd["backbone"]
    if any(k.startswith("backbone.") for k in sd):
        return {k[len("backbone."):]: v for k, v in sd.items() if k.startswith("backbone.")}
    return sd


class CheckpointManager:
    """Keep-N rotating checkpoints under `directory`, one subdirectory per
    step, written by one background thread.

    ``save`` is gated as orbax gates it: the first save always goes through,
    then only steps past the latest that are multiples of
    `save_interval_steps` (``force`` bypasses the gate). Loops ask
    :meth:`should_save` before building what they would save, since the host
    copy of a ViT-H train state is several GB. The gate reads the steps on
    disk once, at construction, and then the saves made since, so that every
    process of a group decides alike while process 0 is still writing."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3,
                 save_interval_steps: int = 1):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self.writes = process_index() == 0
        self._writer = ThreadPoolExecutor(max_workers=1, thread_name_prefix="checkpoint")
        self._pending = None
        self._pending_step: Optional[int] = None
        steps = self.all_steps()
        self._gate_step: Optional[int] = steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        """The steps whose checkpoints are complete on disk, ascending."""
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and is_checkpoint(os.path.join(self.directory, d)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps() + ([self._pending_step] if self._pending is not None else [])
        return max(steps) if steps else None

    def should_save(self, step: int) -> bool:
        """Whether ``save(step)`` would write (the interval gate)."""
        last = self._gate_step
        if last is not None and step <= last:
            return False
        return last is None or step % self.save_interval_steps == 0

    def save(self, step: int, tree: Dict[str, Any], force: bool = False):
        """Copy `tree` to host memory now and write it in the background.
        Returns the host copy ({} on a process that does not write), or None
        where the gate declines."""
        if not (force or self.should_save(step)):
            return None
        self.wait()  # one write at a time: at most one host copy in flight
        self._gate_step = step if self._gate_step is None else max(self._gate_step, step)
        if not self.writes:  # gathers what the writer needs, keeps nothing
            to_host(tree, keep=False)
            return {}
        host = to_host(tree)
        self._pending_step = step
        self._pending = self._writer.submit(self._write, step, host)
        return host

    def _write(self, step: int, host: Dict[str, Any]) -> None:
        save_tree(os.path.join(self.directory, str(step)), host)
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)

    def restore(self, step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """The tree of `step` (the latest when None), or None when there is
        no checkpoint."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return load_tree(os.path.join(self.directory, str(step)))

    def wait(self) -> None:
        """Block until the background write has finished; raise its error.
        Every process of a group calls it at the same points: the others
        wait there for process 0's write."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()
        barrier()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._writer.shutdown()


def save_teacher(directory: str, iteration: int, teacher_tree: Dict[str, Any]) -> str:
    """Teacher-only export for the eval paths, written before it returns
    (reference: dinov2/train/train.py:128-137): ``<directory>/eval/
    <iteration>/teacher``, a checkpoint of `teacher_tree` ({"backbone":
    state_dict, "dino_head": state_dict, ...}). Every process of a group
    calls it; process 0 writes, the others wait for it."""
    path = os.path.abspath(os.path.join(directory, "eval", str(iteration), "teacher"))
    if process_index() == 0:
        save_tree(path, to_host(teacher_tree))
    else:  # gathers what process 0 writes, keeps nothing
        to_host(teacher_tree, keep=False)
    barrier()
    return path


def load_teacher(path: str) -> Dict[str, Any]:
    return load_tree(path)


class PreemptionGuard:
    """Records SIGTERM / SIGUSR1 so that a loop saves a final checkpoint and
    stops (the reference's submitit requeue hook, trainer.py:16-26). The
    handlers are installed from the main thread only (elsewhere the guard
    never fires); :meth:`close` puts the previous handlers back."""

    def __init__(self):
        self._requested = threading.Event()
        self._previous = {}
        for sig in (signal.SIGTERM, signal.SIGUSR1):
            try:
                self._previous[sig] = signal.signal(sig, self._handler)
            except ValueError:  # not the main thread
                pass

    def _handler(self, signum, frame):  # noqa: ARG002
        self._requested.set()

    @property
    def preempted(self) -> bool:
        return self._requested.is_set()

    def close(self) -> None:
        for sig, handler in self._previous.items():
            signal.signal(sig, signal.SIG_DFL if handler is None else handler)
        self._previous = {}
