"""Shared pieces of the RT-DETR port tests (tests/test_torch_rtdetr*.py): a tiny RT-DETR graph (the JAX
package's tests/test_rtdetr.py ``_tiny_spec``) built by both packages on one set of seeded variables, the
JAX denoising draws, and seeded padded-label batches."""

from __future__ import annotations

import numpy as np

GRAPHS = ("rtdetr-l.yaml", "rtdetr-x.yaml", "rtdetr-resnet50.yaml", "rtdetr-resnet101.yaml", "yolov8-rtdetr.yaml")


def tiny_dict(nc: int = 4) -> dict:
    """HGStem, HGBlocks (plain and light), DWConvs, AIFI, RepC3s and a 3-level RTDETRDecoder at narrow widths."""
    return {
        "nc": nc,
        "scales": {"l": [1.0, 1.0, 1024]},
        "backbone": [
            [-1, 1, "HGStem", [8, 16]],
            [-1, 1, "HGBlock", [8, 32, 3]],
            [-1, 1, "DWConv", [32, 3, 2, 1, False]],
            [-1, 1, "HGBlock", [8, 32, 3]],
            [-1, 1, "DWConv", [32, 3, 2, 1, False]],
            [-1, 1, "HGBlock", [8, 32, 5, True, False]],
        ],
        "head": [
            [-1, 1, "Conv", [32, 1, 1, None, 1, 1, False]],
            [-1, 1, "AIFI", [32, 4]],
            [-1, 1, "Conv", [32, 1, 1]],
            [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
            [3, 1, "Conv", [32, 1, 1, None, 1, 1, False]],
            [[-2, -1], 1, "Concat", [1]],
            [-1, 1, "RepC3", [32]],
            [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
            [1, 1, "Conv", [32, 1, 1, None, 1, 1, False]],
            [[-2, -1], 1, "Concat", [1]],
            [-1, 1, "RepC3", [32]],
            [[16, 12, 8], 1, "RTDETRDecoder", [nc]],
        ],
    }


def tiny_specs(nc: int = 4):
    """(JAX spec, port spec) of ``tiny_dict``."""
    import copy

    from bsyolo_tpu.nn import parse_model_yaml as jax_parse

    from bsyolo_tpu_torch.nn.parser import parse_model_yaml

    return jax_parse(copy.deepcopy(tiny_dict(nc)), scale="l"), parse_model_yaml(copy.deepcopy(tiny_dict(nc)), scale="l")


def tiny_models(nc: int = 4, seed: int = 0, hw=(64, 64)):
    """(JAX graph, its seeded variables as numpy, port graph on the CPU with the same variables, port spec)."""
    from bsyolo_tpu.nn.model import DetectionGraph

    from bsyolo_tpu_torch.nn.model import build_model
    from torch_port import port_module_from_jax, random_variables, to_plain_dict, variable_shapes

    js, ps = tiny_specs(nc)
    jm = DetectionGraph(js)
    variables = to_plain_dict(random_variables(variable_shapes(jm, (1, *hw, 3)), seed))
    port = port_module_from_jax(build_model(ps, "cpu"), variables)
    return jm, variables, port, ps


def jax_cdn_draws(rng, b: int, total: int, nc: int):
    """The four draws JAX's ``static_cdn_group`` makes from ``rng``, as numpy: flip uniforms, random classes,
    sign bits and box parts."""
    import jax

    k1, k2, k3, k4 = jax.random.split(rng, 4)
    return (np.asarray(jax.random.uniform(k1, (b, total))), np.asarray(jax.random.randint(k2, (b, total), 0, nc)),
            np.asarray(jax.random.randint(k3, (b, total, 4), 0, 2)), np.asarray(jax.random.uniform(k4, (b, total, 4))))


def label_batch(seed: int, b: int, m: int, nc: int, n_valid=(3, 1)):
    """Seeded padded labels: cls (B, M) int32, bboxes (B, M, 4) normalized xywh, mask (B, M) float32 with the
    first ``n_valid[i]`` slots of image i valid."""
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, nc, (b, m)).astype(np.int32)
    xy = rng.uniform(0.25, 0.75, (b, m, 2))
    wh = rng.uniform(0.1, 0.4, (b, m, 2))
    bboxes = np.concatenate([xy, wh], -1).astype(np.float32)
    mask = np.zeros((b, m), np.float32)
    for i in range(b):
        mask[i, : n_valid[i % len(n_valid)]] = 1.0
    return cls, bboxes * mask[..., None], mask


def spy_cdn_draws(monkeypatch, captured):
    """Record the four draws JAX's ``static_cdn_group`` makes in a jitted run, made as it makes them, as
    tensors."""
    import jax
    import torch

    import bsyolo_tpu.nn.transformer as JT

    orig = JT.static_cdn_group

    def spy(gt_cls, gt_bboxes, gt_mask, class_embed, num_classes, num_queries, rng, num_dn=100, *a, **k):
        B, M = gt_cls.shape
        total = 2 * max(num_dn // M, 1) * M
        k1, k2, k3, k4 = jax.random.split(rng, 4)
        draws = (jax.random.uniform(k1, (B, total)), jax.random.randint(k2, (B, total), 0, num_classes),
                 jax.random.randint(k3, (B, total, 4), 0, 2), jax.random.uniform(k4, (B, total, 4)))
        jax.debug.callback(lambda *d: captured.append([torch.from_numpy(np.array(x)) for x in d]), *draws)
        return orig(gt_cls, gt_bboxes, gt_mask, class_embed, num_classes, num_queries, rng, num_dn, *a, **k)

    monkeypatch.setattr(JT, "static_cdn_group", spy)


def use_draws(monkeypatch, draws):
    """Make the port's ``static_cdn_group`` take ``draws``."""
    import functools

    import bsyolo_tpu_torch.nn.transformer as PT

    monkeypatch.setattr(PT, "static_cdn_group", functools.partial(PT.static_cdn_group, draws=draws))


def write_tiny_yaml(path, nc: int = 3):
    """``tiny_dict`` as a model YAML file, for the facades and the CLI."""
    import json
    from pathlib import Path

    d = tiny_dict(nc)
    rows = lambda key: "".join(f"  - {json.dumps(r)}\n" for r in d[key])
    Path(path).write_text(f"nc: {nc}\nscales:\n  l: [1.0, 1.0, 1024]\nbackbone:\n{rows('backbone')}head:\n{rows('head')}")
    return str(path)
