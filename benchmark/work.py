"""The yardstick of the op layer: the H100's peaks, the least time an op's
work can take on it, and the work of each op call from ``ops/<name>.json``.

An op file names the op's autograd Function (``forward``) and its backward
node (``backward``), the argument whose leading sizes are a call's images and
tokens (``fwd_arg`` among the Function's arguments, ``bwd_arg`` among the
gradients its backward node takes, as the profiler records their shapes), and
gives for each direction the bytes it must move
(each input read once, each output written once), its tensor-core
operations and its float32 operations outside the tensor cores, as
arithmetic over the call's shape: ``b`` images, ``n`` tokens, width ``c``,
``heads``, with ``m = b n``, ``c8 = c / 8``, ``e = 2`` bytes an activation
and ``bias`` 1 or 0. The formulas of the forwards are those of the kernel
table's bounds (a frozen copy of the smoke script's ``work``); the
backwards count the products of the gradients of every input that has one.
"""

from __future__ import annotations

import ast
import json
import operator
from pathlib import Path
from typing import Dict, Tuple

HERE = Path(__file__).resolve().parent

# NVIDIA H100 SXM, dense, at the 700 W limit (data sheet): bf16 tensor cores,
# float32 outside the tensor cores, HBM3
PEAK_TC, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12

_OPS = {ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
        ast.Div: operator.truediv, ast.Pow: operator.pow, ast.USub: operator.neg}


def evaluate(expr: str, env: Dict[str, float]) -> float:
    """An arithmetic expression over the names of `env` (+ - * / ** and
    parentheses, numbers); nothing else parses."""
    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
            return node.value
        if isinstance(node, ast.Name) and node.id in env:
            return env[node.id]
        if isinstance(node, ast.BinOp) and type(node.op) in _OPS:
            return _OPS[type(node.op)](ev(node.left), ev(node.right))
        if isinstance(node, ast.UnaryOp) and type(node.op) in _OPS:
            return _OPS[type(node.op)](ev(node.operand))
        raise ValueError(f"not plain arithmetic: {ast.dump(node)}")
    return float(ev(ast.parse(expr, mode="eval")))


def load_ops() -> Dict[str, dict]:
    """Op name -> its file's contents, for every file under ``ops/``."""
    return {p.stem: json.loads(p.read_text()) for p in sorted((HERE / "ops").glob("*.json"))}


def shape_env(b: int, n: int, c: int, heads: int, bias: bool) -> Dict[str, float]:
    return {"b": b, "n": n, "c": c, "heads": heads, "m": b * n, "c8": c / 8, "e": 2,
            "bias": 1 if bias else 0}


def work(spec: dict, direction: str, env: Dict[str, float]) -> Tuple[float, float, float]:
    """(bytes, tensor-core operations, float32 operations) of one call."""
    w = spec[direction]
    return tuple(evaluate(w.get(k, "0"), env) for k in ("bytes", "tc_ops", "f32_ops"))


def bound_s(nbytes: float, tc_ops: float, f32_ops: float = 0.0) -> float:
    """The least seconds the card could take for this work."""
    return max(nbytes / PEAK_BYTES, tc_ops / PEAK_TC, f32_ops / PEAK_F32)
