"""The RT-DETR family in the PyTorch port against bsyolo_tpu: the five graph files (byte for byte, spec and
parameters), the HGNetv2 and neck blocks and AIFI on a non-square map (rtol 1e-4), the deformable
attention (rtol 1e-5), the eval-mode decoder of a tiny graph (rtol 1e-4, equal top-k queries), the
denoising group on JAX's draws (equal, the mask exact), the Hungarian matcher (equal assignments) and the
DETR loss (2e-3). The train step: tests/test_torch_rtdetr_step.py. Shared pieces: tests/rtdetr_port.py."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import jax
import jax.numpy as jnp
import torch

from rtdetr_port import GRAPHS, jax_cdn_draws, label_batch, spy_cdn_draws, tiny_models, use_draws
from torch_port import nchw, port_module_from_jax, random_variables, to_plain_dict, variable_shapes
from zoo_port import assert_graph_is_jax

JAX_MODELS = Path(__file__).resolve().parent.parent / "bsyolo_tpu" / "cfg" / "models"
RTOL = 1e-4


def test_graph_files_are_the_jax_packages():
    from bsyolo_tpu_torch.cfg import CFG_ROOT

    for name in GRAPHS:
        (mine,) = (CFG_ROOT / "models").rglob(name)
        assert mine.read_bytes() == (JAX_MODELS / mine.parent.name / name).read_bytes(), name


@pytest.mark.parametrize("name", GRAPHS)
def test_graph_parameters_equal_jax(name):
    """Spec, parameter names, shapes and count at full width, through ``jax.eval_shape`` of the init."""
    assert_graph_is_jax(name)


def test_facade_builds_rtdetr_l():
    from bsyolo_tpu_torch import RTDETR, YOLO

    m = RTDETR(device="cpu")
    assert (m.model_path, m.task, m.spec.head.module, m.spec.nc) == ("rtdetr-l.yaml", "detect", "RTDETRDecoder", 80)
    assert YOLO("yolov8n-rtdetr.yaml", device="cpu").spec.scale == "n"


def _block_pair(jax_block, port_block, x, seed):
    variables = to_plain_dict(random_variables(variable_shapes(jax_block, x.shape), seed))
    want = jax.jit(lambda v, a: jax_block.apply(v, a, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port_module_from_jax(port_block, variables)(torch.from_numpy(nchw(x)))
    return got.numpy(), nchw(np.asarray(want))


BLOCKS = {
    # name -> (JAX block, port block, input channels)
    "HGStem": (lambda J, T: J.HGStem(8, 16), lambda P, T: P.HGStem(3, 8, 16), 3),
    "HGBlock": (lambda J, T: J.HGBlock(8, 32, 3, 3), lambda P, T: P.HGBlock(16, 8, 32, 3, 3), 16),
    "HGBlock-light-shortcut": (lambda J, T: J.HGBlock(8, 32, 5, 2, True, True),
                               lambda P, T: P.HGBlock(32, 8, 32, 5, 2, True, True), 32),
    "LightConv": (lambda J, T: J.LightConv(16, 5), lambda P, T: P.LightConv(8, 16, 5), 8),
    "RepC3": (lambda J, T: J.RepC3(16, 2), lambda P, T: P.RepC3(8, 16, 2), 8),
    "AIFI": (lambda J, T: T.AIFI(64, 4), lambda P, T: T.AIFI(32, 64, 4), 32),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_jax_on_a_non_square_map(name):
    """Each block on a 6 x 10 map (HGStem on 24 x 40); AIFI's w-major table meets h-major tokens here."""
    import bsyolo_tpu.nn.modules as JM
    import bsyolo_tpu.nn.transformer as JT

    import bsyolo_tpu_torch.nn.modules as PM
    import bsyolo_tpu_torch.nn.transformer as PT

    jb, pb, c = BLOCKS[name]
    hw = (24, 40) if name == "HGStem" else (6, 10)
    x = np.random.default_rng(3).normal(0, 1, (2, *hw, c)).astype(np.float32)
    got, want = _block_pair(jb(JM, JT), pb(PM, PT), x, seed=4)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("ref_dim", [2, 4])
def test_ms_deform_attn_matches_jax(ref_dim):
    """Three levels (one non-square), 4 heads, 4 points; the random offsets carry samples past the maps'
    edges, where the zero padding acts."""
    import bsyolo_tpu.nn.transformer as JT

    from bsyolo_tpu_torch.nn.transformer import MSDeformAttn

    shapes = ((6, 10), (3, 5), (2, 3))
    rng = np.random.default_rng(5)
    B, Q, C = 2, 7, 32
    q = rng.normal(0, 1, (B, Q, C)).astype(np.float32)
    v = rng.normal(0, 1, (B, sum(h * w for h, w in shapes), C)).astype(np.float32)
    rb = rng.uniform(0.1, 0.9, (B, Q, 3, ref_dim)).astype(np.float32)
    jm = JT.MSDeformAttn(C, 3, 4, 4)
    shp = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), q, rb, v, shapes))
    variables = to_plain_dict(random_variables(shp, 6))
    want = np.asarray(jax.jit(lambda p, a, b, c: jm.apply(p, a, b, c, shapes))(variables, q, rb, v))
    with torch.no_grad():
        got = port_module_from_jax(MSDeformAttn(C, 3, 4, 4), variables)(
            torch.from_numpy(q), torch.from_numpy(rb), torch.from_numpy(v), shapes).numpy()
    print(f"MSDeformAttn ({ref_dim}-d reference): max |diff| {np.abs(got - want).max():.3g} of {np.abs(want).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module")
def tiny():
    """The tiny RT-DETR graph of both packages on one set of variables (variables drawn at 64 x 96)."""
    jm, variables, port, spec = tiny_models(hw=(64, 96))
    return jm, variables, port, spec


def _capture_top_k(monkeypatch, calls):
    """Record (values, indices) of every ``jax.lax.top_k`` in a jitted JAX run."""
    orig = jax.lax.top_k

    def spy(x, k):
        v, i = orig(x, k)
        jax.debug.callback(lambda a, b: calls.append((np.asarray(a), np.asarray(b))), v, i)
        return v, i

    monkeypatch.setattr(jax.lax, "top_k", spy)


def _capture_port_top_k(monkeypatch, calls):
    """Record (values, indices) of every ``top_k_stable`` of the port's decoder."""
    import bsyolo_tpu_torch.nn.transformer as PT

    orig = PT.top_k_stable

    def spy(x, k):
        v, i = orig(x, k)
        calls.append((v.detach().numpy(), i.numpy()))
        return v, i

    monkeypatch.setattr(PT, "top_k_stable", spy)


def test_decoder_eval_matches_jax(tiny, monkeypatch):
    """Eval mode of the tiny graph at 64 x 96 (a non-square P5 map): the selected queries (the same anchors
    in the same order) and every output within rtol 1e-4."""
    jm, variables, port, _ = tiny
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 96, 3)).astype(np.float32)
    jax_k, port_k = [], []
    _capture_top_k(monkeypatch, jax_k)
    want = jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, jnp.asarray(x))
    jax.effects_barrier()
    _capture_port_top_k(monkeypatch, port_k)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(nchw(x)))
    np.testing.assert_array_equal(port_k[0][1], jax_k[0][1])
    assert port_k[0][1].shape == (2, 300)
    for k in ("dec_bboxes", "dec_scores", "enc_bboxes", "enc_scores"):
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=RTOL, atol=RTOL * np.abs(w).max(), err_msg=k)


def test_static_cdn_group_matches_jax():
    """JAX's group on a key, the port's on the draws JAX made from it: embeddings, boxes (logit space) and
    validity equal, the attention mask exact; M = 128 (the loader's padding) gives one group."""
    import bsyolo_tpu.nn.transformer as JT

    import bsyolo_tpu_torch.nn.transformer as PT

    for m, nq in ((128, 300), (8, 40)):
        cls, bb, mask = label_batch(2, 2, m, 5)
        embed = np.random.default_rng(3).normal(0, 1, (5, 16)).astype(np.float32)
        key = jax.random.PRNGKey(11)
        want = jax.jit(lambda c, b, k, e: JT.static_cdn_group(c, b, k, e, 5, nq, key))(cls, bb, mask, embed)
        total = 2 * max(100 // m, 1) * m
        draws = [torch.from_numpy(np.array(d)) for d in jax_cdn_draws(key, 2, total, 5)]
        got = PT.static_cdn_group(torch.from_numpy(cls).long(), torch.from_numpy(bb), torch.from_numpy(mask),
                                  torch.from_numpy(embed), 5, nq, draws=draws)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))  # attention mask
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))  # validity
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-5)
        jm, pm = want[4], got[4]
        assert (pm["num_group"], pm["num_dn"], pm["M"]) == (jm["num_group"], jm["num_dn"], jm["M"])
        np.testing.assert_array_equal(pm["is_neg"].numpy(), np.asarray(jm["is_neg"]))
    assert pm["num_group"] == 12 and want[4]["num_group"] == 12


@pytest.fixture(scope="module")
def train_outputs(tiny):
    """Train-mode outputs of both packages at 64 x 96 with 8 padded labels (3 and 1 valid) and the same
    denoising draws, and JAX's loss items on its own outputs."""
    from bsyolo_tpu.losses.detr import rtdetr_loss

    mp = pytest.MonkeyPatch()
    jm, variables, port, _ = tiny
    x = np.random.default_rng(2).uniform(0, 1, (2, 64, 96, 3)).astype(np.float32)
    cls, bb, mask = label_batch(0, 2, 8, 4)
    tg = {"cls": cls, "bboxes": bb, "mask": mask}
    captured, jax_k, port_k = [], [], []
    saved = {k: v.clone() for k, v in port.state_dict().items()}
    try:
        spy_cdn_draws(mp, captured)
        _capture_top_k(mp, jax_k)

        def run(v, a, t):
            o, _ = jm.apply(v, a, train=True, targets=t, rngs={"dn": jax.random.PRNGKey(5)}, mutable=["batch_stats"])
            return {k: o[k] for k in o if k != "dn_meta"}, rtdetr_loss(o, t["cls"], t["bboxes"], t["mask"])[1]

        want, items = jax.jit(run)(variables, jnp.asarray(x), tg)
        jax.effects_barrier()
        use_draws(mp, captured[0])
        _capture_port_top_k(mp, port_k)
        port.train()
        got = port(torch.from_numpy(nchw(x)), targets={k: torch.from_numpy(v) for k, v in tg.items()})
    finally:
        mp.undo()
        port.load_state_dict(saved)  # train mode moved the BatchNorm statistics
        port.eval()
    return {k: np.asarray(v) for k, v in want.items()}, np.asarray(items), got, tg, jax_k[0], port_k[0]


def test_train_mode_decoder_matches_jax(train_outputs):
    """Train-mode outputs with the denoising queries first (8 labels: 12 groups of 16). Train-mode
    BatchNorm on the 4 x 6 P5 map moves the encoder's scores by float order (about 1e-4), so the 300 of
    504 anchors selected are the same set, in the same order but where two scores tie that closely; the
    port's queries reordered to JAX's order, every output within 1e-2 of its scale (the step test below
    holds the gradients), the validity exact."""
    want, _, got, _, (jv, ji), (pv, pi) = train_outputs
    assert got["dn_meta"]["num_dn"] == 192 and got["dec_bboxes"].shape == (6, 2, 492, 4)
    np.testing.assert_array_equal(got["dn_valid"].numpy(), want["dn_valid"])
    order = []
    for b in range(2):
        assert set(pi[b]) == set(ji[b])
        pos = {a: j for j, a in enumerate(pi[b])}
        order.append([pos[a] for a in ji[b]])
        moved = np.flatnonzero(pi[b] != ji[b])
        assert len(moved) <= 10 and (np.abs(pv[b][moved] - jv[b][moved]) <= 1e-3 * np.abs(jv[b]).max()).all()
    order = np.asarray(order)
    for k in ("dec_bboxes", "dec_scores", "enc_bboxes", "enc_scores"):
        g = got[k].detach().numpy()
        if k.startswith("dec"):
            main = np.stack([g[:, b, 192:][:, order[b]] for b in range(2)], 1)
            g = np.concatenate([g[:, :, :192], main], 2)
        else:
            g = np.stack([g[b][order[b]] for b in range(2)])
        np.testing.assert_allclose(g, want[k], rtol=1e-2, atol=1e-2 * np.abs(want[k]).max(), err_msg=k)


def test_hungarian_matches_and_loss_match_jax(train_outputs):
    """Both matchers on the same predictions (each decoder layer's and the encoder's): equal assignments.
    Both losses on the same predictions, and the port's loss on its own forward against JAX's: 2e-3."""
    from bsyolo_tpu.losses.detr import hungarian_match as jax_match, rtdetr_loss as jax_loss

    from bsyolo_tpu_torch.losses.detr import hungarian_match, rtdetr_loss

    want, jax_items, got, tg = train_outputs[:4]
    cls, bb, mask = (torch.from_numpy(tg[k]) for k in ("cls", "bboxes", "mask"))
    sets = [(want["dec_bboxes"][i, :, 192:], want["dec_scores"][i, :, 192:]) for i in range(6)]
    sets.append((want["enc_bboxes"], want["enc_scores"]))
    jmatch = jax.jit(jax_match)
    for pb, ps in sets:
        a = np.asarray(jmatch(pb, ps, tg["cls"], tg["bboxes"], tg["mask"]))
        b = hungarian_match(torch.tensor(pb), torch.tensor(ps), cls, bb, mask).numpy()
        np.testing.assert_array_equal(b, a)
        assert (b[0, :3] >= 0).all() and b[1, 0] >= 0 and (b[0, 3:] == -1).all() and (b[1, 1:] == -1).all()
    meta = got["dn_meta"]
    same = {k: torch.tensor(v) for k, v in want.items()}
    _, items = rtdetr_loss({**same, "dn_meta": meta}, cls, bb, mask)
    jmeta = {"num_dn": 192, "M": 8, "num_group": 12}
    _, want_items = jax.jit(lambda o: jax_loss({**o, "dn_meta": jmeta}, tg["cls"], tg["bboxes"], tg["mask"]))(want)
    np.testing.assert_allclose(items.numpy(), np.asarray(want_items), rtol=2e-3)
    np.testing.assert_allclose(np.asarray(want_items), jax_items, rtol=1e-5)
    _, own = rtdetr_loss(got, cls, bb, mask)
    print(f"loss items: port {own.detach().numpy()}, JAX {jax_items}")
    np.testing.assert_allclose(own.detach().numpy(), jax_items, rtol=2e-3)
