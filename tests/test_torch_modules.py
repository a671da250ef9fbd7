"""Block-level parity of the PyTorch port (bsyolo_tpu_torch.nn.modules/heads) against bsyolo_tpu.

Every block of the BS-YOLO graph at narrow widths (8-32 channels, 16 px maps),
JAX variables carried over with state_dict_from_jax, outputs compared after
NHWC -> NCHW at rtol 1e-4, atol 1e-5 in float32.
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
        "Conv": (16, lambda: J.ConvBN(24, 3, 2), lambda: P.Conv(16, 24, 3, 2)),
        "DWConv": (16, lambda: J.DWConvBN(32, 3, 1), lambda: P.DWConv(16, 32, 3, 1)),
        "Bottleneck": (16, lambda: J.Bottleneck(16, True), lambda: P.Bottleneck(16, 16, True)),
        "C2f": (16, lambda: J.C2f(32, 2, True), lambda: P.C2f(16, 32, 2, True)),
        "C3": (16, lambda: J.C3(32, 1, True), lambda: P.C3(16, 32, 1, True)),
        "C3k": (16, lambda: J.C3k(32, 2, True), lambda: P.C3k(16, 32, 2, True)),
        "C3k2-c3k=False": (16, lambda: J.C3k2(32, 1, True, 1, 0.5, c3k=False),
                           lambda: P.C3k2(16, 32, 1, c3k=False, e=0.5, g=1, shortcut=True)),
        "C3k2-c3k=True": (16, lambda: J.C3k2(32, 1, True, 1, 0.5, c3k=True),
                          lambda: P.C3k2(16, 32, 1, c3k=True, e=0.5, g=1, shortcut=True)),
        "PMSFA": (32, lambda: J.PMSFA(), lambda: P.PMSFA(32)),
        "C3k_gai": (16, lambda: J.C3k_gai(32, 1, True), lambda: P.C3k_gai(16, 32, 1, True)),
        "C3k2_gai-c3k=False": (16, lambda: J.C3k2_gai(32, 2, True, 1, 0.5, c3k=False),
                               lambda: P.C3k2_gai(16, 32, 2, c3k=False, e=0.5, g=1, shortcut=True)),
        "C3k2_gai-c3k=True": (16, lambda: J.C3k2_gai(32, 1, True, 1, 0.5, c3k=True),
                              lambda: P.C3k2_gai(16, 32, 1, c3k=True, e=0.5, g=1, shortcut=True)),
        "SPPF": (16, lambda: J.SPPF(24, 5), lambda: P.SPPF(16, 24, 5)),
        "SCDown": (16, lambda: J.SCDown(32, 3, 2), lambda: P.SCDown(16, 32, 3, 2)),
        "Attention-2heads": (32, lambda: J.Attention(32, num_heads=2, attn_ratio=0.5),
                             lambda: P.Attention(32, num_heads=2, attn_ratio=0.5)),
        "PSABlock": (32, lambda: J.PSABlock(32, 0.5, 2), lambda: P.PSABlock(32, 0.5, 2)),
        "C2PSA": (32, lambda: J.C2PSA(32, 2), lambda: P.C2PSA(32, 32, 2)),
        "MSCAAttention": (16, lambda: J.MSCAAttention(16), lambda: P.MSCAAttention(16)),
        "ELA": (32, lambda: J.ELA(32), lambda: P.ELA(32)),
    }


CASES = [
    "Conv", "DWConv", "Bottleneck", "C2f", "C3", "C3k", "C3k2-c3k=False", "C3k2-c3k=True", "PMSFA", "C3k_gai",
    "C3k2_gai-c3k=False", "C3k2_gai-c3k=True", "SPPF", "SCDown", "Attention-2heads", "PSABlock", "C2PSA",
    "MSCAAttention", "ELA",
]


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
    np.testing.assert_allclose(got.numpy(), nchw(want), rtol=RTOL, atol=ATOL)


def test_detect_head_matches_jax(rng):
    from bsyolo_tpu.nn.heads import Detect as JDetect
    from bsyolo_tpu_torch.nn.heads import Detect

    feats = [rng.normal(0, 1, (2, s, s, c)).astype(np.float32) for s, c in ((16, 16), (8, 32))]
    jmod = JDetect(12, (16, 32), (8, 16))
    variables, pmod = _carry(jmod, Detect(12, (16, 32), (8, 16)), [jnp.asarray(f) for f in feats], seed=7)
    want = jmod.apply(variables, [jnp.asarray(f) for f in feats], train=False)
    with torch.no_grad():
        got = pmod([torch.from_numpy(nchw(f)) for f in feats])
    for g, w in zip(got, want):
        assert g.shape[1] == 64 + 12
        np.testing.assert_allclose(g.numpy(), nchw(w), rtol=RTOL, atol=ATOL)


def test_detect_bias_init_matches_jax():
    """The port's own init sets the same head bias constants as the JAX init."""
    from bsyolo_tpu.nn.heads import Detect as JDetect
    from bsyolo_tpu_torch.nn.heads import Detect

    feats = [jnp.zeros((1, 8, 8, 16)), jnp.zeros((1, 4, 4, 32))]
    params = JDetect(12, (16, 32), (8, 16)).init(jax.random.PRNGKey(0), feats)["params"]
    head = Detect(12, (16, 32), (8, 16))
    head.bias_init()
    for i in range(2):
        np.testing.assert_array_equal(head.cv2[i][2].bias.detach().numpy(), np.asarray(params[f"cv2_{i}_2"]["bias"]))
        np.testing.assert_allclose(head.cv3[i][2].bias.detach().numpy(), np.asarray(params[f"cv3_{i}_2"]["bias"]),
                                   rtol=1e-7)


def test_upsample_and_dfl_decode_match_jax(rng):
    from bsyolo_tpu.nn.modules import dfl_decode as jdfl, upsample2x_nearest
    from bsyolo_tpu_torch.nn.modules import dfl_decode

    x = rng.normal(0, 1, (2, 4, 6, 8)).astype(np.float32)
    up = torch.nn.Upsample(scale_factor=2, mode="nearest")(torch.from_numpy(nchw(x)))
    np.testing.assert_array_equal(up.numpy(), nchw(upsample2x_nearest(jnp.asarray(x))))
    logits = rng.normal(0, 3, (2, 50, 64)).astype(np.float32)
    np.testing.assert_allclose(dfl_decode(torch.from_numpy(logits)).numpy(), np.asarray(jdfl(jnp.asarray(logits))),
                               rtol=1e-5, atol=1e-5)


def test_decode_detections_matches_jax(rng):
    """Raw maps -> (B, A, 4 + nc) xywh pixels + sigmoid scores; rtol 1e-5, atol 1e-4 px."""
    from bsyolo_tpu.nn.heads import decode_detections as jdecode
    from bsyolo_tpu_torch.nn.heads import decode_detections

    feats = [rng.normal(0, 2, (2, s, s, 64 + 12)).astype(np.float32) for s in (8, 4, 2)]
    want = jdecode([jnp.asarray(f) for f in feats], (8, 16, 32), 12)
    got = decode_detections([torch.from_numpy(nchw(f)) for f in feats], (8, 16, 32), 12)
    assert got.shape == (2, 64 + 16 + 4, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
