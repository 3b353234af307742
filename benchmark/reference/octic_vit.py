"""Plain float32 forward of the hybrid octic ViT, written from the model's
equations in plain PyTorch. It imports nothing of the program: it reads the
seeded weights by their parameter names and works out again everything the
program derives from them (the lifted patch-embedding matrix, the unfolded
positional embedding, the head layout of the octic attention).

The octic half carries each token as four 1-d irrep slots ``ones [B, N, 4,
C/8]`` (A1, A2, B1, B2) and the two rows of the 2-d irrep ``erows [B, N, 2,
C/4]`` (row 0 = E11|E12, row 1 = E21|E22). At the break the slots are laid
side by side as ``[A1|A2|B1|B2|E11|E21|E12|E22]`` and standard pre-norm
blocks finish the network.

``quant`` is applied to both operands of every product (linear maps, the
patch embedding, q k^T and P v): the identity for the reference, a rounding
to float8 for the control (:func:`fp8`).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

ROOT2_4 = math.sqrt(2.0) / 4.0


def ident(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per tensor (its largest
    magnitude to 448), back in x's dtype; the gradient passes straight
    through."""
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = 448.0 / amax
    q = (x.detach().float() * scale).to(torch.float8_e4m3fn).float().div(scale).to(x.dtype)
    return x + (q - x).detach()


def _rot(x: torch.Tensor, k: int) -> torch.Tensor:
    return torch.rot90(x, k, dims=(0, 1))


def lift_1d(w: torch.Tensor, sign: float, mirror: float) -> torch.Tensor:
    """A quadrant ``[p/2, p/2, ...]`` folded out to the full ``[p, p, ...]``
    grid of a 1-d irrep: rotation by 90 degrees multiplies by `sign`, the
    mirror of the second axis by `mirror`."""
    q = ROOT2_4 * w
    left = torch.cat([q, sign * _rot(q, 1)], dim=0)
    right = torch.cat([sign * _rot(q, 3), _rot(q, 2)], dim=0)
    full = torch.cat([left, right], dim=1)
    return full + mirror * torch.flip(full, (1,))


def lift_e(w: torch.Tensor) -> torch.Tensor:
    """A quadrant folded out to the first component of the 2-d irrep."""
    half = 0.5 * w
    col = torch.cat([half, torch.flip(half, (0,))], dim=0)
    return torch.cat([col, -torch.flip(col, (1,))], dim=1)


# (rotation sign, mirror sign) of the 1-d irreps A1, A2, B1, B2
ONE_D = ((1.0, 1.0), (1.0, -1.0), (-1.0, 1.0), (-1.0, -1.0))


def patch_matrix(p: Dict[str, torch.Tensor], prefix: str = "patch_embed.") -> torch.Tensor:
    """``[p*p*3, 8*C/8]``: the patch embedding's weight in slot order
    A1 A2 B1 B2 E11 E21 E12 E22, rows in (row, column, channel) order."""
    names = ("w_a1", "w_a2", "w_b1", "w_b2")
    ks = [lift_1d(p[prefix + n], *s) for n, s in zip(names, ONE_D)]
    left, right = lift_e(p[prefix + "w_e_left"]), lift_e(p[prefix + "w_e_right"])
    ks += [left, _rot(left, 1), right, _rot(right, 1)]
    k = torch.cat(ks, dim=-1)
    return k.reshape(-1, k.shape[-1])


def unfold_pos(pos: torch.Tensor) -> torch.Tensor:
    """The six quadrant tensors ``[6, g/2, g/2, C/8]`` -> the full grid
    ``[g, g, 8, C/8]`` in slot order."""
    def four(x, sign):
        top = torch.cat((x, sign * _rot(x, 1)), dim=0)
        bot = torch.cat((sign * _rot(x, 3), _rot(x, 2)), dim=0)
        return torch.cat((top, bot), dim=1)

    slots = []
    for i, (sign, mirror) in enumerate(ONE_D):
        f = four(pos[i], sign)
        slots.append(f + mirror * torch.flip(f, (1,)))

    def e(x):
        col = torch.cat((x, torch.flip(x, (0,))), dim=0)
        return torch.cat((col, -torch.flip(col, (1,))), dim=1)

    left, right = e(pos[4]), e(pos[5])
    slots += [left, _rot(left, 1), right, _rot(right, 1)]
    return torch.stack(slots, dim=2)


def patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """NHWC images -> ``[B, L, p*p*3]`` rows of (row, column, channel)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // patch, patch, w // patch, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // patch) * (w // patch), patch * patch * c)


def slots_to_state(s: torch.Tensor) -> tuple:
    """``[..., 8, c]`` slots -> (ones ``[..., 4, c]``, erows ``[..., 2, 2c]``)."""
    ones = s[..., :4, :]
    erows = torch.stack((torch.cat((s[..., 4, :], s[..., 6, :]), -1),
                         torch.cat((s[..., 5, :], s[..., 7, :]), -1)), dim=-2)
    return ones, erows


def state_to_slots(ones: torch.Tensor, erows: torch.Tensor) -> torch.Tensor:
    h = erows.shape[-1] // 2
    e = (erows[..., 0, :h], erows[..., 1, :h], erows[..., 0, h:], erows[..., 1, h:])
    return torch.cat((ones, torch.stack(e, dim=-2)), dim=-2)


# the isotypic -> regular change of basis over the slots (A1 A2 B1 B2 E11 E21
# E12 E22): an orthogonal 8 x 8 matrix whose row g, every entry +-sqrt(2)/4,
# gives the coordinate of one group element
REGULAR = ROOT2_4 * torch.tensor([
    [1, 1, 1, 1, 1, 1, 1, -1],
    [1, 1, -1, -1, 1, -1, -1, -1],
    [1, 1, 1, 1, -1, -1, -1, 1],
    [1, 1, -1, -1, -1, 1, 1, 1],
    [1, -1, 1, -1, -1, 1, -1, -1],
    [1, -1, -1, 1, -1, -1, 1, -1],
    [1, -1, 1, -1, 1, -1, 1, 1],
    [1, -1, -1, 1, 1, 1, -1, 1],
], dtype=torch.float64)


def d8_gelu(ones: torch.Tensor, erows: torch.Tensor) -> tuple:
    """GELU applied pointwise in the regular representation."""
    m = REGULAR.to(device=ones.device, dtype=ones.dtype)
    s = state_to_slots(ones, erows)
    reg = torch.einsum("gs,...sc->...gc", m, s)
    iso = torch.einsum("gs,...gc->...sc", m, F.gelu(reg))
    return slots_to_state(iso)


def d8_layer_norm(ones, erows, alpha_1d, alpha_e, beta_a1, eps: float = 1e-5) -> tuple:
    """Per-irrep mean removal (each E row its own), one std per token shared by
    all slots: sqrt(2)/4 * sqrt(sum of the 1-d variances + the mean of the two
    E rows' variances + eps); then the per-slot affine (bias on A1)."""
    ones = ones - ones.mean(-1, keepdim=True)
    erows = erows - erows.mean(-1, keepdim=True)
    var = ones.square().mean(-1).sum(-1) + 0.5 * erows.square().mean(-1).sum(-1)
    inv = 1.0 / (ROOT2_4 * torch.sqrt(var + eps))
    ones = ones * inv[..., None, None] * alpha_1d
    ones = torch.cat((ones[..., :1, :] + beta_a1, ones[..., 1:, :]), dim=-2)
    return ones, erows * inv[..., None, None] * alpha_e


def d8_linear(ones, erows, w1d, we, bias, q: Callable) -> tuple:
    """The equivariant linear map: one matrix per 1-d irrep, one matrix for
    both E rows, a bias on A1 only."""
    o = torch.einsum("...gc,gcf->...gf", q(ones), q(w1d))
    if bias is not None:
        o = torch.cat((o[..., :1, :] + bias, o[..., 1:, :]), dim=-2)
    return o, torch.matmul(q(erows), q(we))


def attention(qh, kh, vh, q: Callable) -> torch.Tensor:
    """Softmax attention over ``[B, N, H, d]`` heads."""
    s = torch.einsum("bqhd,bkhd->bhqk", q(qh), q(kh)) * qh.shape[-1] ** -0.5
    return torch.einsum("bhqk,bkhd->bqhd", q(s.softmax(-1)), q(vh))


def octic_attention(ones, erows, heads: int, q: Callable) -> tuple:
    """Attention over the qkv of the octic block. Each 1-d slot of width 3C/8
    holds (q, k, v) x heads x C/(8 heads); each E row of width 3C/4 holds (q,
    k, v) x heads x C/(4 heads). A head's query is its share of all six,
    C/heads wide."""
    b, n = ones.shape[:2]
    d1 = ones.shape[-1] // (3 * heads)
    o1 = ones.reshape(b, n, 4, 3, heads, d1).permute(0, 1, 3, 4, 2, 5).reshape(
        b, n, 3, heads, 4 * d1)
    oe = erows.reshape(b, n, 2, 3, heads, 2 * d1).permute(0, 1, 3, 4, 2, 5).reshape(
        b, n, 3, heads, 4 * d1)
    qkv = torch.cat((o1, oe), dim=-1)
    out = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], q)
    out1 = out[..., :4 * d1].reshape(b, n, heads, 4, d1).permute(0, 1, 3, 2, 4).reshape(
        b, n, 4, heads * d1)
    oute = out[..., 4 * d1:].reshape(b, n, heads, 2, 2 * d1).permute(0, 1, 3, 2, 4).reshape(
        b, n, 2, heads * 2 * d1)
    return out1, oute


def octic_block(ones, erows, p: Dict[str, torch.Tensor], pre: str, heads: int, q: Callable,
                masks: tuple = (None, None), eps: float = 1e-5) -> tuple:
    def get(name):
        return p.get(pre + name)

    def branch_add(ones, erows, y1, ye, ls, mask):
        y1 = y1 * get(ls + ".alpha_1d")
        ye = ye * get(ls + ".alpha_e")
        if mask is not None:
            y1, ye = y1 * mask[..., None], ye * mask[..., None]
        return ones + y1, erows + ye

    h1, he = d8_layer_norm(ones, erows, get("norm1.affine.alpha_1d"),
                           get("norm1.affine.alpha_e"), get("norm1.affine.beta_a1"), eps)
    h1, he = d8_linear(h1, he, get("attn.qkv.kernel_1d"), get("attn.qkv.kernel_e"),
                       get("attn.qkv.bias_a1"), q)
    h1, he = octic_attention(h1, he, heads, q)
    h1, he = d8_linear(h1, he, get("attn.proj.kernel_1d"), get("attn.proj.kernel_e"),
                       get("attn.proj.bias_a1"), q)
    ones, erows = branch_add(ones, erows, h1, he, "ls1", masks[0])
    h1, he = d8_layer_norm(ones, erows, get("norm2.affine.alpha_1d"),
                           get("norm2.affine.alpha_e"), get("norm2.affine.beta_a1"), eps)
    h1, he = d8_linear(h1, he, get("mlp.fc1.kernel_1d"), get("mlp.fc1.kernel_e"),
                       get("mlp.fc1.bias_a1"), q)
    h1, he = d8_gelu(h1, he)
    h1, he = d8_linear(h1, he, get("mlp.fc2.kernel_1d"), get("mlp.fc2.kernel_e"),
                       get("mlp.fc2.bias_a1"), q)
    return branch_add(ones, erows, h1, he, "ls2", masks[1])


def linear(x, w, b, q: Callable) -> torch.Tensor:
    y = torch.matmul(q(x), q(w).t())
    return y if b is None else y + b


def standard_block(x, p: Dict[str, torch.Tensor], pre: str, heads: int, q: Callable,
                   masks: tuple = (None, None), eps: float = 1e-6) -> torch.Tensor:
    def get(name):
        return p.get(pre + name)

    b, n, c = x.shape
    h = F.layer_norm(x, (c,), get("norm1.weight"), get("norm1.bias"), eps)
    qkv = linear(h, get("attn.qkv.weight"), get("attn.qkv.bias"), q)
    qkv = qkv.reshape(b, n, 3, heads, c // heads)
    a = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], q).reshape(b, n, c)
    y = get("gamma_1") * linear(a, get("attn.proj.weight"), get("attn.proj.bias"), q)
    x = x + (y if masks[0] is None else y * masks[0])
    h = F.layer_norm(x, (c,), get("norm2.weight"), get("norm2.bias"), eps)
    h = F.gelu(linear(h, get("mlp.fc1.weight"), get("mlp.fc1.bias"), q))
    y = get("gamma_2") * linear(h, get("mlp.fc2.weight"), get("mlp.fc2.bias"), q)
    return x + (y if masks[1] is None else y * masks[1])


def cubic_matrix(n_in: int, n_out: int) -> torch.Tensor:
    """``[n_out, n_in]`` bicubic interpolation (a = -0.75, half-pixel
    centres, edges clamped), in float64."""
    a = -0.75

    def k(x):
        x = abs(x)
        if x <= 1.0:
            return (a + 2.0) * x ** 3 - (a + 3.0) * x ** 2 + 1.0
        return a * x ** 3 - 5.0 * a * x ** 2 + 8.0 * a * x - 4.0 * a if x < 2.0 else 0.0

    m = torch.zeros(n_out, n_in, dtype=torch.float64)
    for i in range(n_out):
        pos = (i + 0.5) * n_in / n_out - 0.5
        base = math.floor(pos)
        for tap in range(-1, 3):
            m[i, min(max(base + tap, 0), n_in - 1)] += k(tap - (pos - base))
    return m


def pos_grid(p: Dict[str, torch.Tensor], g: int) -> torch.Tensor:
    """The positional embedding ``[g, g, 8, C/8]`` of a ``g x g`` patch grid:
    the unfolded grid, resized bicubically where g differs from it."""
    pos = unfold_pos(p["pos_embed"])
    if pos.shape[0] != g:
        m = cubic_matrix(pos.shape[0], g).to(pos)
        pos = torch.einsum("oh,hwsc->owsc", m, pos)
        pos = torch.einsum("ow,hwsc->hosc", m, pos)
    return pos


def features(p: Dict[str, torch.Tensor], cfg: dict, images: torch.Tensor,
             q: Callable = ident, masks: Optional[list] = None,
             token_masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The final-normed tokens ``[B, 1 + L, C]`` (cls first) of NHWC `images`.
    `masks` holds each block's two per-sample drop-path scales ``[B, 1, 1]``;
    `token_masks` ``[B, L]`` (bool) replaces the masked patches' embeddings by
    the mask token (its A1 slot a parameter, the others 0) before the
    positional embedding is added."""
    patch, heads, depth = cfg["patch_size"], cfg["num_heads"], cfg["depth"]
    brk = cfg["break_layer"]
    b, hgt, wid, _ = images.shape
    g = hgt // patch
    if hgt != wid:
        raise ValueError("the reference takes square images")
    tok = torch.matmul(q(patchify(images, patch)), q(patch_matrix(p)))
    tok = tok.reshape(b, g * g, 8, -1)
    tok = torch.cat((tok[..., :1, :] + p["patch_embed.bias_a1"], tok[..., 1:, :]), dim=-2)
    if token_masks is not None:
        mask_tok = torch.zeros_like(tok[0, 0])
        mask_tok[0] = p["mask_token_a1"][0]
        tok = torch.where(token_masks[..., None, None], mask_tok, tok)
    tok = tok + pos_grid(p, g).reshape(g * g, 8, -1)
    cls = torch.zeros(b, 1, 8, tok.shape[-1], dtype=tok.dtype, device=tok.device)
    cls[:, :, 0] = p["cls_token_a1"]
    ones, erows = slots_to_state(torch.cat((cls, tok), dim=1))
    masks = masks or [(None, None)] * depth
    for i in range(brk):
        ones, erows = octic_block(ones, erows, p, f"blocks.{i}.", heads, q, masks[i])
    x = state_to_slots(ones, erows).flatten(-2)
    for i in range(brk, depth):
        x = standard_block(x, p, f"blocks.{i}.", heads, q, masks[i])
    return F.layer_norm(x, (x.shape[-1],), p["norm.weight"], p["norm.bias"], 1e-6)


def forward(p: Dict[str, torch.Tensor], cfg: dict, images: torch.Tensor,
            q: Callable = ident, masks: Optional[list] = None) -> torch.Tensor:
    """Logits ``[B, classes]`` of NHWC `images` (float32): the head on the
    normed cls token; the normed cls token itself for a model without a head."""
    x = features(p, cfg, images, q, masks)
    if "head.weight" not in p:
        return x[:, 0]
    return linear(x[:, 0], p["head.weight"], p["head.bias"], q)
