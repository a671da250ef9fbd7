"""Blocks of the YOLO v3, v5, v6, v8, v9 and v10 graphs in the PyTorch port against bsyolo_tpu.

Each block at narrow widths (8-32 channels, 16 px maps), JAX variables carried over with
state_dict_from_jax, outputs compared after NHWC -> NCHW at rtol 1e-4, atol 1e-5 in float32 (the
gate of tests/test_torch_modules.py); the legacy Detect head, the v10Detect head and its bias init,
the graph layers (max pool, zero pad, space-to-depth, the bare transposed conv, CBLinear and CBFuse)
and the graph-wide activation the same way.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import jax
import jax.numpy as jnp
import torch

from torch_port import nchw, port_module_from_jax, random_variables

RTOL, ATOL = 1e-4, 1e-5


def _cases():
    from bsyolo_tpu.nn import modules as J

    from bsyolo_tpu_torch.nn import modules as P

    # name: (c1, JAX module, port module)
    return {
        "C2": (16, lambda: J.C2(32, 2, True), lambda: P.C2(16, 32, 2, True)),
        "SPP": (16, lambda: J.SPP(24), lambda: P.SPP(16, 24)),
        "GhostConv": (16, lambda: J.GhostConv(32, 3, 2), lambda: P.GhostConv(16, 32, 3, 2)),
        "GhostBottleneck-s1": (16, lambda: J.GhostBottleneck(16, 3, 1), lambda: P.GhostBottleneck(16, 16, 3, 1)),
        "GhostBottleneck-s2": (16, lambda: J.GhostBottleneck(32, 3, 2), lambda: P.GhostBottleneck(16, 32, 3, 2)),
        "C3Ghost": (16, lambda: J.C3Ghost(32, 2), lambda: P.C3Ghost(16, 32, 2)),
        "RepVGGDW": (16, lambda: J.RepVGGDW(), lambda: P.RepVGGDW(16)),
        "CIB": (16, lambda: J.CIB(16, True), lambda: P.CIB(16, 16, True)),
        "CIB-lk": (16, lambda: J.CIB(32, True, lk=True), lambda: P.CIB(16, 32, True, lk=True)),
        "C2fCIB": (16, lambda: J.C2fCIB(32, 1, True, lk=False), lambda: P.C2fCIB(16, 32, 1, True, False)),
        "C2fCIB-lk": (16, lambda: J.C2fCIB(32, 2, True, lk=True), lambda: P.C2fCIB(16, 32, 2, True, True)),
        "PSA": (32, lambda: J.PSA(32), lambda: P.PSA(32, 32)),
        "RepConv": (16, lambda: J.RepConv(24), lambda: P.RepConv(16, 24)),
        "RepBottleneck": (16, lambda: J.RepBottleneck(16, True), lambda: P.RepBottleneck(16, 16, True)),
        "RepCSP": (16, lambda: J.RepCSP(32, 2), lambda: P.RepCSP(16, 32, 2)),
        "RepNCSPELAN4": (16, lambda: J.RepNCSPELAN4(32, 32, 16, 1), lambda: P.RepNCSPELAN4(16, 32, 32, 16, 1)),
        "ELAN1": (16, lambda: J.ELAN1(32, 16, 8), lambda: P.ELAN1(16, 32, 16, 8)),
        "AConv": (16, lambda: J.AConv(32), lambda: P.AConv(16, 32)),
        "ADown": (16, lambda: J.ADown(32), lambda: P.ADown(16, 32)),
        "SPPELAN": (16, lambda: J.SPPELAN(32, 8), lambda: P.SPPELAN(16, 32, 8)),
        "ResNetBlock": (16, lambda: J.ResNetBlock(8, 2), lambda: P.ResNetBlock(16, 8, 2)),
        "ResNetBlock-identity": (32, lambda: J.ResNetBlock(8, 1), lambda: P.ResNetBlock(32, 8, 1)),
        "ResNetLayer-first": (3, lambda: J.ResNetLayer(16, 1, True, 1), lambda: P.ResNetLayer(3, 16, 1, True, 1)),
        "ResNetLayer": (16, lambda: J.ResNetLayer(8, 2, False, 3), lambda: P.ResNetLayer(16, 8, 2, False, 3)),
        "ConvTranspose2d": (16, lambda: J.ConvTranspose2dLayer(24, 2, 2),
                            lambda: P.ConvTranspose2d(16, 24, 2, 2, 0, bias=True)),
    }


CASES = list(_cases())


def _carry(jmod, pmod, inputs, seed):
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), inputs, train=False))
    variables = random_variables(shapes, seed)
    return variables, port_module_from_jax(pmod, variables)


@pytest.mark.parametrize("name", CASES)
def test_block_matches_jax(name, rng):
    c1, jfac, pfac = _cases()[name]
    x = rng.normal(0, 1, (2, 16, 16, c1)).astype(np.float32)
    jmod = jfac()
    variables, pmod = _carry(jmod, pfac(), jnp.asarray(x), seed=CASES.index(name))
    want = jmod.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = pmod(torch.from_numpy(nchw(x)))
    assert got.shape == nchw(want).shape
    np.testing.assert_allclose(got.numpy(), nchw(want), rtol=RTOL, atol=ATOL)


def test_block_parameter_names_follow_the_jax_paths():
    """Every block's state_dict keys are the JAX variables' translated paths, and ``jax_paths`` inverts them."""
    from bsyolo_tpu_torch.nn.model import DetectionGraph
    from bsyolo_tpu_torch.nn.parser import LayerSpec, ModelSpec
    from bsyolo_tpu_torch.utils.weights import flax_path_to_torch_key, jax_paths

    for name in CASES:
        c1, jfac, pfac = _cases()[name]
        shapes = jax.eval_shape(lambda: jfac().init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, c1)), train=False))
        want = {}
        for collection, tree in shapes.items():
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]:
                keys = tuple(p.key for p in path)
                want[flax_path_to_torch_key(collection, ("m0",) + keys)] = (collection, ("m0",) + keys)
        graph = DetectionGraph(ModelSpec(layers=(LayerSpec(0, (-1,), 1, "Identity", (), c1, c1, 1),), save=(), nc=1,
                                         scale=""))
        graph.model[0] = pfac()
        assert jax_paths(graph) == want, name


@pytest.mark.parametrize("act", ["relu", "lrelu", "hardswish", "mish", "gelu"])
def test_graph_activation_matches_jax(act, rng):
    """A graph's ``activation:`` reaches every Conv (the JAX ConvBN reads it from a module global at trace time;
    the port sets it on each Conv of one graph) and leaves RepConv's own SiLU."""
    from bsyolo_tpu.nn import modules as J

    from bsyolo_tpu_torch.nn import modules as P

    x = rng.normal(0, 1, (2, 16, 16, 16)).astype(np.float32)
    J.set_default_act(act)
    try:
        jmod = J.RepNCSPELAN4(32, 32, 16, 1)
        variables, pmod = _carry(jmod, P.RepNCSPELAN4(16, 32, 32, 16, 1), jnp.asarray(x), seed=3)
        want = jmod.apply(variables, jnp.asarray(x), train=False)
    finally:
        J.set_default_act("silu")
    P.set_activation(pmod, act)
    with torch.no_grad():
        got = pmod(torch.from_numpy(nchw(x)))
    np.testing.assert_allclose(got.numpy(), nchw(want), rtol=RTOL, atol=ATOL)
    assert isinstance(pmod.cv2[0].m[0].cv1.conv1.act, torch.nn.Identity)  # RepConv's branches have none


def test_activation_is_per_graph_not_global():
    """Two graphs built one after the other keep their own activations (the JAX package holds one global)."""
    from bsyolo_tpu_torch.nn.model import build_model
    from bsyolo_tpu_torch.nn.parser import load_model_yaml, parse_model_yaml
    from bsyolo_tpu_torch.cfg import model_yaml_path

    v6 = build_model(parse_model_yaml(load_model_yaml(model_yaml_path("yolov6n.yaml"))), "cpu")
    v8 = build_model(parse_model_yaml(load_model_yaml(model_yaml_path("yolov8n.yaml"))), "cpu")
    acts6 = {type(m.act).__name__ for m in v6.modules() if hasattr(m, "bn")}
    acts8 = {type(m.act).__name__ for m in v8.modules() if hasattr(m, "bn")}
    assert v6.spec.act == "relu" and acts6 == {"ReLU"}
    assert v8.spec.act == "silu" and acts8 == {"SiLU"}


def _levels(rng, sizes=((16, 16), (8, 32), (4, 24))):
    return [rng.normal(0, 1, (2, s, s, c)).astype(np.float32) for s, c in sizes]


@pytest.mark.parametrize("head", ["Detect-legacy", "Segment-legacy", "Pose-legacy", "OBB-legacy"])
def test_legacy_heads_match_jax(head, rng):
    """The legacy class branch (two 3x3 convs) of each level head."""
    from bsyolo_tpu.nn import heads as JH

    from bsyolo_tpu_torch.nn import heads as PH

    feats = _levels(rng)
    ch, strides = (16, 32, 24), (8, 16, 32)
    jmod, pmod = {
        "Detect-legacy": (lambda: JH.Detect(5, ch, strides, legacy=True),
                          lambda: PH.Detect(5, ch, strides, legacy=True)),
        "Segment-legacy": (lambda: JH.Segment(5, ch, strides, 8, 16, legacy=True),
                           lambda: PH.Segment(5, 8, 16, ch, strides, legacy=True)),
        "Pose-legacy": (lambda: JH.Pose(5, ch, strides, (4, 3), legacy=True),
                        lambda: PH.Pose(5, (4, 3), ch, strides, legacy=True)),
        "OBB-legacy": (lambda: JH.OBB(5, ch, strides, 1, legacy=True), lambda: PH.OBB(5, 1, ch, strides, legacy=True)),
    }[head]
    jmod = jmod()
    variables, pmod = _carry(jmod, pmod(), [jnp.asarray(f) for f in feats], seed=11)
    want = jmod.apply(variables, [jnp.asarray(f) for f in feats], train=False)
    with torch.no_grad():
        got = pmod([torch.from_numpy(nchw(f)) for f in feats])
    if isinstance(want, dict):
        np.testing.assert_allclose(got["proto"].numpy(), nchw(want["proto"]), rtol=RTOL, atol=ATOL)
        got, want = got["feats"], want["feats"]
    assert len(pmod.cv3[0]) == 3 and isinstance(pmod.cv3[0][0].conv, torch.nn.Conv2d)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), nchw(w), rtol=RTOL, atol=ATOL)


def test_v10_head_matches_jax_and_detaches_its_one_to_one_branch(rng):
    from bsyolo_tpu.nn.heads import v10Detect as JV10

    from bsyolo_tpu_torch.nn.heads import v10Detect

    feats = _levels(rng)
    ch, strides = (16, 32, 24), (8, 16, 32)
    jmod = JV10(7, ch, strides)
    variables, pmod = _carry(jmod, v10Detect(7, ch, strides), [jnp.asarray(f) for f in feats], seed=12)
    want = jmod.apply(variables, [jnp.asarray(f) for f in feats], train=False)
    xs = [torch.from_numpy(nchw(f)).requires_grad_() for f in feats]
    got = pmod(xs)
    assert set(got) == set(want) == {"one2many", "one2one"}
    for key in ("one2many", "one2one"):
        for g, w in zip(got[key], want[key]):
            assert g.shape[1] == 64 + 7
            np.testing.assert_allclose(g.detach().numpy(), nchw(w), rtol=RTOL, atol=ATOL)
    sum(f.sum() for f in got["one2one"]).backward()  # stop_gradient: the levels get nothing from one2one
    assert all(x.grad is None for x in xs)
    assert pmod.one2one_cv2[0][0].conv.weight.grad is not None


def test_v10_bias_init_matches_jax():
    from bsyolo_tpu.nn.heads import v10Detect as JV10

    from bsyolo_tpu_torch.nn.heads import v10Detect

    feats = [jnp.zeros((1, 8, 8, 16)), jnp.zeros((1, 4, 4, 32))]
    params = JV10(12, (16, 32), (8, 16)).init(jax.random.PRNGKey(0), feats)["params"]
    head = v10Detect(12, (16, 32), (8, 16))
    head.bias_init()
    for prefix in ("", "one2one_"):
        for i in range(2):
            box = getattr(head, f"{prefix}cv2")[i][2].bias.detach().numpy()
            cls = getattr(head, f"{prefix}cv3")[i][2].bias.detach().numpy()
            np.testing.assert_array_equal(box, np.asarray(params[f"{prefix}cv2_{i}_2"]["bias"]))
            np.testing.assert_allclose(cls, np.asarray(params[f"{prefix}cv3_{i}_2"]["bias"]), rtol=1e-7)


def test_graph_layers_match_jax(rng):
    """MaxPool2d, ZeroPad2d and SpaceToDepth as the JAX graph runs them; CBLinear's taps and CBFuse's sum with
    nearest resizes at integer factors (v9e's) and at one that is not an integer."""
    from bsyolo_tpu.nn import modules as J

    from bsyolo_tpu_torch.nn import modules as P

    x = rng.normal(0, 1, (2, 12, 16, 8)).astype(np.float32)
    t = torch.from_numpy(nchw(x))
    np.testing.assert_array_equal(torch.nn.MaxPool2d(2, 1, 0)(torch.nn.ZeroPad2d((0, 1, 0, 1))(t)).numpy(),
                                  nchw(J.max_pool2d(J.zero_pad2d(jnp.asarray(x), (0, 1, 0, 1)), 2, 1, 0)))
    np.testing.assert_array_equal(torch.nn.MaxPool2d(3, 2, 1)(t).numpy(), nchw(J.max_pool2d(jnp.asarray(x), 3, 2, 1)))
    np.testing.assert_array_equal(P.SpaceToDepth(2)(t).numpy(), nchw(J.space_to_depth(jnp.asarray(x), 2)))
    jlin = J.CBLinear((4, 8, 12))
    variables, plin = _carry(jlin, P.CBLinear(8, (4, 8, 12)), jnp.asarray(x), seed=5)
    want = jlin.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = plin(t)
    assert len(got) == 3 and [g.shape[1] for g in got] == [4, 8, 12]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), nchw(w), rtol=RTOL, atol=ATOL)
    for target_hw in ((24, 32), (48, 64), (18, 40)):  # factors 2, 4 and a ragged 1.5 x 2.5
        target = rng.normal(0, 1, (2, *target_hw, 8)).astype(np.float32)
        taps = [tuple(rng.normal(0, 1, (2, 12, 16, c)).astype(np.float32) for c in (8, 8))]
        want = J.cb_fuse([tuple(jnp.asarray(a) for a in taps[0]), jnp.asarray(target)], [1])
        got = P.CBFuse((1,))([tuple(torch.from_numpy(nchw(a)) for a in taps[0]), torch.from_numpy(nchw(target))])
        np.testing.assert_array_equal(got.numpy(), nchw(want))
