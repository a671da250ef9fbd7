"""RT-DETR's transformer (counterpart of ``bsyolo_tpu/nn/transformer.py``): AIFI, the multi-scale
deformable attention, the decoder layer, the static contrastive-denoising group and ``RTDETRDecoder``.

Parameters carry the reference torch names (``ma.in_proj_weight``, ``decoder.layers.{i}``,
``input_proj.{i}.{j}``, ``denoising_class_embed.weight``), which ``utils/weights.py`` maps onto the
JAX package's paths. The numerics follow the JAX modules, not stock torch:

- ``LayerNorm`` (``nn/modules.py``) is flax's: epsilon 1e-6 (torch's default is 1e-5), the variance as E[x^2] - E[x]^2
  clipped at 0, statistics in float32;
- attention projects q, k and v apart with the rows of ``in_proj_weight``, in the input's dtype; its
  logits and softmax are float32, masked positions take -1e9 (not -inf), the weights return to v's dtype;
- the deformable sampling is bilinear with zero padding and ``align_corners=False``, in the JAX
  package's gather form and arithmetic, in float32 whatever the graph's dtype, as is the softmax of its
  attention weights over levels and points;
- the encoder's query selection takes the top ``min(nq, anchors)`` of the float32 best class logit with
  ties to the lower anchor (``lax.top_k``'s order, ``losses/segment.py top_k_stable``); anchors outside
  (0.01, 0.99) are ``inf`` and their features zero;
- ``static_cdn_group`` lays the denoising queries out as the JAX package does (the padded label count M
  is the group stride), drawing its noise from a ``torch.Generator``; JAX's ``jax.random`` bits cannot be
  reproduced, so the draws can also be passed in.

In the bf16 graph (``nn.model.set_compute_dtype``) every ``Linear`` and the input projections' convs
compute in bfloat16; boxes, reference points, sampling and softmaxes stay float32 by type promotion, as
in the flax graph.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from bsyolo_tpu_torch.losses.segment import top_k_stable
from bsyolo_tpu_torch.nn.modules import BN_EPS, BN_MOMENTUM, BatchNorm2d, Conv2d, LayerNorm, Linear, at_least_f32
from bsyolo_tpu_torch.ops.boxes import xywh2xyxy, xyxy2xywh

def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


class MultiheadAttention(nn.Module):
    """Batch-first multi-head attention with torch's parameter layout (``in_proj_weight`` (3C, C),
    ``in_proj_bias``, ``out_proj``); ``attn_mask`` True blocks a position."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = Linear(dim, dim)

    def init_parameters(self, generator: torch.Generator) -> None:
        bound = math.sqrt(6.0 / (4 * self.dim))  # xavier_uniform of the (3C, C) matrix
        with torch.no_grad():
            self.in_proj_weight.uniform_(-bound, bound, generator=generator)
            self.in_proj_bias.zero_()

    def forward(self, q, k, v, attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        C, H = self.dim, self.num_heads
        hd = C // H
        dt = q.dtype
        wq, wk, wv = self.in_proj_weight.to(dt).chunk(3)
        bq, bk, bv = self.in_proj_bias.to(dt).chunk(3)
        B, Q, _ = q.shape
        K = k.shape[1]
        q = F.linear(q, wq, bq).view(B, Q, H, hd).transpose(1, 2)
        k = F.linear(k, wk, bk).view(B, K, H, hd).transpose(1, 2)
        v = F.linear(v, wv, bv).view(B, K, H, hd).transpose(1, 2)
        attn = (at_least_f32(q) @ at_least_f32(k).transpose(-2, -1)) / math.sqrt(hd)
        if attn_mask is not None:
            attn = attn.masked_fill(attn_mask, -1e9)
        attn = attn.softmax(-1).to(v.dtype)
        return self.out_proj((attn @ v).transpose(1, 2).reshape(B, Q, C))


def build_2d_sincos_pos_embed(w: int, h: int, embed_dim: int, temperature: float = 10000.0) -> torch.Tensor:
    """The reference AIFI's 2-D sin-cos table, (1, h * w, embed_dim), w-major, in float32 (numpy, as JAX's)."""
    grid_w, grid_h = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32), indexing="ij")
    pos_dim = embed_dim // 4
    omega = 1.0 / (temperature ** (np.arange(pos_dim, dtype=np.float32) / pos_dim))
    out_w = grid_w.flatten()[:, None] @ omega[None]
    out_h = grid_h.flatten()[:, None] @ omega[None]
    pe = np.concatenate([np.sin(out_w), np.cos(out_w), np.sin(out_h), np.cos(out_h)], axis=1)[None]
    return torch.from_numpy(np.ascontiguousarray(pe, np.float32))


class AIFI(nn.Module):
    """Intra-scale feature interaction: one transformer encoder layer over the flattened P5 map with 2-D
    sin-cos positions (exact GELU). The table is w-major and the tokens h-major; they are added by flat
    index, as the reference does."""

    def __init__(self, c1: int, cm: int = 2048, num_heads: int = 8):
        super().__init__()
        self.ma = MultiheadAttention(c1, num_heads)
        self.fc1 = Linear(c1, cm)
        self.fc2 = Linear(cm, c1)
        self.norm1 = LayerNorm(c1)
        self.norm2 = LayerNorm(c1)
        self._pos: Dict[tuple, torch.Tensor] = {}

    def pos_embed(self, w: int, h: int, c: int, device) -> torch.Tensor:
        key = (w, h, c, str(device))
        if key not in self._pos:
            self._pos[key] = build_2d_sincos_pos_embed(w, h, c).to(device)
        return self._pos[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        src = x.flatten(2).transpose(1, 2)  # (B, HW, C), h-major
        pos = self.pos_embed(W, H, C, x.device).to(x.dtype)
        q = src + pos
        src = self.norm1(src + self.ma(q, q, src))
        src = self.norm2(src + self.fc2(F.gelu(self.fc1(src))))
        return src.transpose(1, 2).reshape(B, C, H, W)


class MLP(nn.Module):
    """``num_layers`` linear layers with ReLU between them."""

    def __init__(self, c1: int, hidden: int, c2: int, num_layers: int):
        super().__init__()
        dims = [c1] + [hidden] * (num_layers - 1) + [c2]
        self.layers = nn.ModuleList(Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


def bilinear_sample(value: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """``grid_sample(mode="bilinear", padding_mode="zeros", align_corners=False)`` in the JAX package's
    gather form and arithmetic. value (N, H, W, C), grid (N, Q, P, 2) in [-1, 1] -> (N, Q, P, C)."""
    N, H, W, C = value.shape
    x = (grid[..., 0] + 1.0) * (W / 2.0) - 0.5
    y = (grid[..., 1] + 1.0) * (H / 2.0) - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]
    flat = value.reshape(N, H * W, C)

    def gather(yi, xi):
        ok = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        idx = yi.clamp(0, H - 1).long() * W + xi.clamp(0, W - 1).long()  # (N, Q, P)
        g = torch.gather(flat, 1, idx.reshape(N, -1, 1).expand(-1, -1, C)).reshape(*idx.shape, C)
        return g * ok[..., None]

    v00, v01 = gather(y0, x0), gather(y0, x0 + 1)
    v10, v11 = gather(y0 + 1, x0), gather(y0 + 1, x0 + 1)
    return v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy) + v10 * (1 - wx) * wy + v11 * wx * wy


def ms_deform_attn_sample(value: torch.Tensor, shapes: Sequence[Tuple[int, int]], locations: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    """Multi-scale deformable sampling (the reference's ``multi_scale_deformable_attn_pytorch``), level by
    level. value (B, len_v, H, hd), locations (B, Q, H, L, P, 2) in [0, 1], weights (B, Q, H, L, P)
    -> (B, Q, H * hd), in value's dtype (float32 on the graph's path)."""
    B, _, H, hd = value.shape
    Q = locations.shape[1]
    grids = 2 * locations - 1
    start = 0
    out = torch.zeros(B, Q, H, hd, dtype=value.dtype, device=value.device)
    for lvl, (h, w) in enumerate(shapes):
        v = value[:, start : start + h * w].permute(0, 2, 1, 3).reshape(B * H, h, w, hd)
        start += h * w
        g = grids[:, :, :, lvl].permute(0, 2, 1, 3, 4).reshape(B * H, Q, -1, 2)
        wl = weights[:, :, :, lvl].permute(0, 2, 1, 3).reshape(B * H, Q, -1)
        acc = (bilinear_sample(v, g) * wl[..., None]).sum(2)  # (BH, Q, hd)
        out = out + acc.reshape(B, H, Q, hd).permute(0, 2, 1, 3)
    return out.reshape(B, Q, H * hd)


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention: each query samples ``n_points`` per head and level around its
    reference box, weighted by a softmax over levels and points."""

    def __init__(self, d_model: int = 256, n_levels: int = 4, n_heads: int = 8, n_points: int = 4):
        super().__init__()
        self.d_model, self.n_levels, self.n_heads, self.n_points = d_model, n_levels, n_heads, n_points
        self.sampling_offsets = Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = Linear(d_model, n_heads * n_levels * n_points)
        self.value_proj = Linear(d_model, d_model)
        self.output_proj = Linear(d_model, d_model)

    def init_parameters(self, generator: torch.Generator) -> None:
        """The reference's init: offsets of zero weight and a ring-of-directions bias, zero attention weights."""
        thetas = np.arange(self.n_heads, dtype=np.float32) * (2.0 * np.pi / self.n_heads)
        grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
        grid = grid / np.abs(grid).max(-1, keepdims=True)
        grid = np.tile(grid[:, None, None, :], (1, self.n_levels, self.n_points, 1))
        for i in range(self.n_points):
            grid[:, :, i, :] *= i + 1
        with torch.no_grad():
            self.sampling_offsets.weight.zero_()
            self.sampling_offsets.bias.copy_(torch.from_numpy(grid.reshape(-1)))
            self.attention_weights.weight.zero_()
            self.attention_weights.bias.zero_()

    def forward(self, query: torch.Tensor, refer_bbox: torch.Tensor, value: torch.Tensor,
                shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """query (B, Q, C); refer_bbox (B, Q, L or 1, 2 or 4) normalized; value (B, len_v, C)."""
        B, Q = query.shape[:2]
        H, L, P = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(value).reshape(B, value.shape[1], H, self.d_model // H)
        off = self.sampling_offsets(query).reshape(B, Q, H, L, P, 2).float()
        w = self.attention_weights(query).reshape(B, Q, H, L * P).float().softmax(-1).reshape(B, Q, H, L, P)
        rb = refer_bbox.float()
        if rb.shape[-1] == 2:
            normalizer = torch.tensor([[wd, ht] for ht, wd in shapes], dtype=torch.float32, device=rb.device)
            loc = rb[:, :, None, :, None, :] + off / normalizer[None, None, None, :, None, :]
        else:
            loc = rb[:, :, None, :, None, :2] + off / P * rb[:, :, None, :, None, 2:] * 0.5
        out = ms_deform_attn_sample(value.float(), shapes, loc, w)
        return self.output_proj(out.to(query.dtype))


class DeformableTransformerDecoderLayer(nn.Module):
    """Self-attention, deformable cross-attention and a ReLU FFN, each followed by a residual LayerNorm."""

    def __init__(self, d_model: int = 256, n_heads: int = 8, d_ffn: int = 1024, n_levels: int = 4,
                 n_points: int = 4):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, n_heads)
        self.norm1 = LayerNorm(d_model)
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm2 = LayerNorm(d_model)
        self.linear1 = Linear(d_model, d_ffn)
        self.linear2 = Linear(d_ffn, d_model)
        self.norm3 = LayerNorm(d_model)

    def forward(self, embed, refer_bbox, feats, shapes, attn_mask=None, query_pos=None):
        q = embed if query_pos is None else embed + query_pos
        embed = self.norm1(embed + self.self_attn(q, q, embed, attn_mask=attn_mask))
        q = embed if query_pos is None else embed + query_pos
        embed = self.norm2(embed + self.cross_attn(q, refer_bbox[:, :, None], feats, shapes))
        return self.norm3(embed + self.linear2(F.relu(self.linear1(embed))))


def cdn_draws(generator: torch.Generator, b: int, total: int, num_classes: int):
    """The four noise draws of ``static_cdn_group`` (flip uniforms (B, T), random classes (B, T), sign bits
    (B, T, 4), box parts (B, T, 4)) from ``generator``, on its device."""
    dev = generator.device
    return (torch.rand(b, total, generator=generator, device=dev),
            torch.randint(0, num_classes, (b, total), generator=generator, device=dev),
            torch.randint(0, 2, (b, total, 4), generator=generator, device=dev),
            torch.rand(b, total, 4, generator=generator, device=dev))


def static_cdn_group(gt_cls: torch.Tensor, gt_bboxes: torch.Tensor, gt_mask: torch.Tensor,
                     class_embed: torch.Tensor, num_classes: int, num_queries: int,
                     generator: Optional[torch.Generator] = None, num_dn: int = 100,
                     cls_noise_ratio: float = 0.5, box_noise_scale: float = 1.0, draws=None):
    """The contrastive-denoising queries at static shapes (the JAX package's ``static_cdn_group``): the
    padded label count M is the group stride, num_group = max(num_dn // M, 1), and the dn axis holds
    [positives (M), negatives (M)] per group. Returns (dn_embed (B, T, hd), dn_bbox (B, T, 4) in logit
    space, attn_mask (T + nq, T + nq) True where blocked, dn validity (B, T), meta).

    The noise comes from ``draws``, the four tensors ``cdn_draws`` returns (a test passes the draws of
    ``jax.random.split(rng, 4)`` made as JAX makes them), else from ``generator``."""
    B, M = gt_cls.shape
    num_group = max(num_dn // M, 1)
    total = 2 * num_group * M
    dev = gt_bboxes.device
    if draws is None:
        if generator is None:
            raise ValueError("static_cdn_group needs a generator or the draws")
        draws = cdn_draws(generator, B, total, num_classes)
    flip_u, rand_cls, sign_bits, part = (torch.as_tensor(d, device=dev) for d in draws)
    cls_t = gt_cls.repeat(1, 2 * num_group)
    box_t = gt_bboxes.float().repeat(1, 2 * num_group, 1)
    mask_t = gt_mask.repeat(1, 2 * num_group).bool()
    is_neg = (torch.arange(total, device=dev) // M) % 2 == 1
    if cls_noise_ratio > 0:
        flip = flip_u < cls_noise_ratio * 0.5
        cls_t = torch.where(flip & mask_t, rand_cls.to(cls_t.dtype), cls_t)
    if box_noise_scale > 0:
        known = xywh2xyxy(box_t)
        diff = (box_t[..., 2:] * 0.5).repeat(1, 1, 2) * box_noise_scale
        sign = sign_bits.float() * 2.0 - 1.0
        part = part.float() + is_neg[None, :, None].float()
        known = (known + sign * part * diff).clamp(0.0, 1.0)
        box_t = xyxy2xywh(known)
    dn_bbox = inverse_sigmoid(box_t, eps=1e-6)
    dn_embed = class_embed[cls_t.clamp(0, num_classes - 1).long()] * mask_t[..., None]
    tgt = total + num_queries
    qi = torch.arange(tgt, device=dev)
    is_dn = qi < total
    gi = torch.where(is_dn, qi // (2 * M), -1)
    attn_mask = (is_dn[:, None] & is_dn[None, :] & (gi[:, None] != gi[None, :])) | (~is_dn[:, None] & is_dn[None, :])
    meta = {"num_group": num_group, "num_dn": total, "M": M, "is_neg": is_neg}
    return dn_embed, dn_bbox, attn_mask, mask_t, meta


class RTDETRDecoder(nn.Module):
    """RT-DETR's head: per-level input projections, the encoder's top-``nq`` query selection, ``ndl``
    deformable decoder layers, each with its box and score heads.

    Eval mode returns ``{"dec_bboxes": (1, B, Q, 4) normalized xywh, "dec_scores": (1, B, Q, nc) logits,
    "enc_bboxes", "enc_scores"}`` of layer ``eval_idx``; train mode every layer's, and with ``targets``
    (``cls``, ``bboxes``, ``mask``, the padded labels) the denoising queries first in the query axis, with
    ``dn_meta`` and ``dn_valid``. Train mode with targets draws the denoising noise from ``generator``,
    which the train step owns."""

    def __init__(self, nc: int = 80, ch: Sequence[int] = (512, 1024, 2048), hd: int = 256, nq: int = 300,
                 ndp: int = 4, nh: int = 8, ndl: int = 6, d_ffn: int = 1024, eval_idx: int = -1,
                 num_denoising: int = 100, label_noise_ratio: float = 0.5, box_noise_scale: float = 1.0):
        super().__init__()
        self.nc, self.hd, self.nq, self.ndl, self.eval_idx = nc, hd, nq, ndl, eval_idx
        self.num_denoising, self.label_noise_ratio, self.box_noise_scale = (num_denoising, label_noise_ratio,
                                                                            box_noise_scale)
        nl = len(ch)
        self.input_proj = nn.ModuleList(
            nn.Sequential(Conv2d(c, hd, 1, bias=False), BatchNorm2d(hd, eps=BN_EPS, momentum=BN_MOMENTUM))
            for c in ch)
        self.denoising_class_embed = nn.Embedding(nc, hd)
        self.enc_output = nn.Sequential(Linear(hd, hd), LayerNorm(hd))
        self.enc_score_head = Linear(hd, nc)
        self.enc_bbox_head = MLP(hd, hd, 4, 3)
        self.query_pos_head = MLP(4, 2 * hd, hd, 2)
        self.decoder = nn.Module()
        self.decoder.layers = nn.ModuleList(DeformableTransformerDecoderLayer(hd, nh, d_ffn, nl, ndp)
                                            for _ in range(ndl))
        self.dec_score_head = nn.ModuleList(Linear(hd, nc) for _ in range(ndl))
        self.dec_bbox_head = nn.ModuleList(MLP(hd, hd, 4, 3) for _ in range(ndl))
        self.generator: Optional[torch.Generator] = None  # the denoising draws' source in train mode
        self._anchors: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def cls_bias(self) -> float:
        """bias_init_with_prob(0.01) / 80 * nc, the score heads' starting bias."""
        return float(-np.log((1 - 0.01) / 0.01) / 80 * self.nc)

    def init_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.denoising_class_embed.weight.normal_(0.0, 1.0, generator=generator)
            for head in (self.enc_score_head, *self.dec_score_head):
                head.bias.fill_(self.cls_bias())

    def anchors(self, shapes, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(1, A, 4) anchors in logit space (``inf`` outside (0.01, 0.99)) and their (1, A, 1) validity,
        made once per level shapes and device."""
        key = (tuple(shapes), str(device))
        if key not in self._anchors:
            out = []
            for i, (h, w) in enumerate(shapes):
                gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32), torch.arange(w, dtype=torch.float32),
                                        indexing="ij")
                xy = (torch.stack([gx, gy], -1) + 0.5) / torch.tensor([w, h], dtype=torch.float32)
                wh = torch.full((h, w, 2), 0.05 * (2.0**i), dtype=torch.float32)
                out.append(torch.cat([xy, wh], -1).reshape(1, h * w, 4))
            a = torch.cat(out, 1)
            valid = ((a > 1e-2) & (a < 1 - 1e-2)).all(-1, keepdim=True)
            a = torch.where(valid, torch.log(a / (1 - a)), torch.tensor(float("inf")))
            self._anchors[key] = (a.to(device), valid.to(device))
        return self._anchors[key]

    def forward(self, x: Sequence[torch.Tensor], targets: Optional[Dict[str, torch.Tensor]] = None):
        train = self.training
        feats_l, shapes = [], []
        for f, proj in zip(x, self.input_proj):
            p = proj(f)
            shapes.append(tuple(p.shape[2:]))
            feats_l.append(p.flatten(2).transpose(1, 2))
        feats = torch.cat(feats_l, 1)  # (B, sum hw, hd)
        B = feats.shape[0]
        nq = min(self.nq, feats.shape[1])

        dn_embed = dn_bbox = attn_mask = dn_valid = dn_meta = None
        if train and targets is not None and self.num_denoising > 0:
            dn_embed, dn_bbox, attn_mask, dn_valid, dn_meta = static_cdn_group(
                targets["cls"], targets["bboxes"], targets["mask"], self.denoising_class_embed.weight, self.nc, nq,
                self.generator, self.num_denoising, self.label_noise_ratio, self.box_noise_scale)

        anchors, valid = self.anchors(shapes, feats.device)
        fmem = self.enc_output(valid.to(feats.dtype) * feats)
        enc_scores_all = self.enc_score_head(fmem)
        _, topk = top_k_stable(enc_scores_all.float().amax(-1), nq)  # (B, nq)
        top_feats = torch.gather(fmem, 1, topk[..., None].expand(-1, -1, fmem.shape[-1]))
        top_anchors = torch.gather(anchors.expand(B, -1, -1), 1, topk[..., None].expand(-1, -1, 4))
        refer_bbox = self.enc_bbox_head(top_feats) + top_anchors
        enc_bboxes = torch.sigmoid(refer_bbox)
        enc_scores = torch.gather(enc_scores_all, 1, topk[..., None].expand(-1, -1, self.nc))
        embeddings = top_feats
        if train:
            refer_bbox, embeddings = refer_bbox.detach(), embeddings.detach()
        if dn_embed is not None:
            embeddings = torch.cat([dn_embed.to(embeddings.dtype), embeddings], 1)
            refer_bbox = torch.cat([dn_bbox.to(refer_bbox.dtype), refer_bbox], 1)

        refer = torch.sigmoid(refer_bbox)
        dec_bboxes: List[torch.Tensor] = []
        dec_scores: List[torch.Tensor] = []
        output, last_refined = embeddings, None
        stop = self.ndl + self.eval_idx if self.eval_idx < 0 else self.eval_idx
        for i, layer in enumerate(self.decoder.layers):
            output = layer(output, refer, feats, shapes, attn_mask=attn_mask, query_pos=self.query_pos_head(refer))
            bbox_delta = self.dec_bbox_head[i](output)
            refined = torch.sigmoid(bbox_delta + inverse_sigmoid(refer))
            if train:
                dec_scores.append(self.dec_score_head[i](output))
                dec_bboxes.append(refined if i == 0 else torch.sigmoid(bbox_delta + inverse_sigmoid(last_refined)))
            elif i == stop:
                dec_scores.append(self.dec_score_head[i](output))
                dec_bboxes.append(refined)
                break
            last_refined = refined
            refer = refined.detach() if train else refined

        out = {"dec_bboxes": torch.stack(dec_bboxes), "dec_scores": torch.stack(dec_scores),
               "enc_bboxes": enc_bboxes, "enc_scores": enc_scores}
        if dn_meta is not None:
            out["dn_meta"], out["dn_valid"] = dn_meta, dn_valid
        return out


def decode_rtdetr(outputs, img_hw: Tuple[int, int], conf_thres: float = 0.25, max_det: int = 300) -> torch.Tensor:
    """Eval-mode decoder outputs -> (B, max_det, 6) rows (xyxy in pixels, conf, cls) without NMS: the
    ``max_det`` queries of highest best sigmoid score (ties to the lower query), those at or below
    ``conf_thres`` zeroed with class -1, as the JAX package's ``decode_rtdetr``."""
    bb = outputs["dec_bboxes"][-1].float()
    sc = torch.sigmoid(outputs["dec_scores"][-1].float())
    h, w = img_hw
    boxes = xywh2xyxy(bb) * torch.tensor([w, h, w, h], dtype=torch.float32, device=bb.device)
    conf, cls = sc.amax(-1), sc.argmax(-1)  # argmax: the first of tied classes, as jnp.argmax
    k = min(max_det, conf.shape[1])
    top_conf, idx = top_k_stable(conf, k)
    top_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    top_cls = torch.gather(cls, 1, idx).float()
    ok = top_conf > conf_thres
    out = torch.cat([torch.where(ok[..., None], top_boxes, 0.0), torch.where(ok, top_conf, 0.0)[..., None],
                     torch.where(ok, top_cls, -1.0)[..., None]], -1)
    if max_det > k:
        pad = torch.zeros(out.shape[0], max_det - k, 6, dtype=out.dtype, device=out.device)
        pad[..., 5] = -1.0
        out = torch.cat([out, pad], 1)
    return out
