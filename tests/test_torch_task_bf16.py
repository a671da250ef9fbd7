"""The bf16 graph on the Segment, Pose, OBB and Classify graphs (``nn.modules.ConvTranspose2d`` and
``Linear``, ``set_compute_dtype``, ``cast_inference_graph``; ``train()`` with its default amp,
``predict(half=True)``, ``val(half=True)``) against bsyolo_tpu's ``dtype=jnp.bfloat16`` graphs.

tests/fixtures/tiny{seg,pose,obb,cls}.yaml with seeded variables carried from JAX. Gates, each
test printing its figures:
- each head alone (Proto's transposed conv, Classify's linear layer), fed the same bfloat16 maps:
  bfloat16 levels and logits within ``GRAPH_NORM`` (tests/test_torch_bf16.py's gate for whole
  graphs) of the JAX head's, norm-relative; Segment's prototypes, four layers that each round to
  bfloat16, within ``BLOCK_NORM`` (that file's gate for blocks; measured 7.8e-3 to 8.0e-3, where
  the port's prototypes are 6.2e-3 to 6.7e-3 from the float32 ones and JAX's 7.6e-3 to 8.3e-3:
  eager flax rounds SiLU's sigmoid and its product apart);
- ``cast_inference_graph`` casts the tensors ``cast_inference_params`` casts (every float32
  weight of rank 2 or more), plus the biases of those layers, which flax casts in every call;
- one amp SGD step (bf16 graph, float32 parameters) from the same weights and batch: loss items
  within ``AMP_LOSS_RTOL`` (tests/test_torch_amp.py's gate), float32 state;
- the Segment and Pose losses with ``assigner_bf16=True`` rank in float32 as JAX's do: items equal
  to the port's with it off, and within ``LOSS_RTOL`` of JAX's;
- ``predict(half=True)`` against the JAX facade's at ``iou=1.0`` (tests/test_torch_bf16.py: bf16
  rounding of near-tied random-weight scores moves suppression decisions): at least ``MATCH_MIN``
  of the rows paired one to one within ``MATCH_PX`` and ``MATCH_SCORE``, with their OBB angles
  within ``MATCH_ANGLE``, their mask pixels equal in at least ``MASK_AGREE`` of the frame or their
  keypoints within ``MATCH_PX``; Classify probabilities within ``PROB_ATOL``;
- ``val(half=True)`` of each graph trained for 60 epochs in float32 on a set that is its own
  validation split (``torch_port.trained_task_checkpoint``): metrics within ``VAL_ATOL`` of the
  JAX facade's on the same checkpoint (a Segment or Pose fitness, the sum of two fitnesses, within
  twice that) (its Classify ``val`` takes no ``half``: the JAX
  ClassificationValidator on the bf16 graph with cast weights stands in).
"""

import itertools
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import jax
import jax.numpy as jnp
import torch

from torch_port import (nchw, port_module_from_jax, port_spec, random_variables, task_batch, task_models,
                        trained_task_checkpoint, write_cls_dataset, write_obb_dataset, write_task_dataset)

GRAPH_NORM = 7.5e-3
BLOCK_NORM = 1e-2
AMP_LOSS_RTOL = 5e-2
LOSS_RTOL = 2e-3
MATCH_PX, MATCH_SCORE, MATCH_MIN, MATCH_ANGLE = 1.0, 1e-2, 0.95, 1e-2
MASK_AGREE = 0.99
PROB_ATOL = 1e-2
VAL_ATOL = 0.02
IMG = 64
FIX = Path(__file__).parent / "fixtures"
TASKS = {"segment": "tinyseg.yaml", "pose": "tinypose.yaml", "obb": "tinyobb.yaml", "classify": "tinycls.yaml"}


def _yaml(task):
    return str(FIX / TASKS[task])


def _bf16(x: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _norm_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def models():
    """task -> (JAX float32 graph, JAX spec, seeded variables, the port's YOLO with them)."""
    return {task: task_models(_yaml(task), IMG, seed=20 + i) for i, task in enumerate(TASKS)}


# --- the heads ------------------------------------------------------------------------------------


def _heads(task):
    """(JAX head in bfloat16, the port's head, the heads' input shapes NHWC)."""
    from bsyolo_tpu.nn import heads as J
    from bsyolo_tpu_torch.nn import heads as P

    bf, ch, strides = jnp.bfloat16, (16, 32), (8, 16)
    levels = [(2, 8, 8, 16), (2, 4, 4, 32)]
    if task == "segment":
        return J.Segment(2, ch, strides, nm=8, npr=16, dtype=bf), P.Segment(2, 8, 16, ch, strides), levels
    if task == "pose":
        return J.Pose(1, ch, strides, kpt_shape=(4, 3), dtype=bf), P.Pose(1, (4, 3), ch, strides), levels
    if task == "obb":
        return J.OBB(2, ch, strides, ne=1, dtype=bf), P.OBB(2, 1, ch, strides), levels
    return J.Classify(3, dtype=bf), P.Classify(32, 3), [(2, 4, 4, 32)]


@pytest.mark.parametrize("task", list(TASKS))
def test_head_bf16_matches_jax(task):
    from bsyolo_tpu_torch.nn.model import set_compute_dtype

    jmod, pmod, shapes = _heads(task)
    rng = np.random.default_rng(list(TASKS).index(task))
    xs = [_bf16(rng.normal(0, 1, s).astype(np.float32)) for s in shapes]
    jx = [jnp.asarray(x, jnp.bfloat16) for x in xs]
    jin = jx if task != "classify" else jx[0]
    variables = random_variables(jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jin)), 30)
    pmod = set_compute_dtype(port_module_from_jax(pmod, variables), torch.bfloat16)
    want = jmod.apply(variables, jin)
    px = [torch.from_numpy(nchw(x)).to(torch.bfloat16) for x in xs]
    with torch.no_grad():
        got = pmod(px if task != "classify" else px[0])
    if task == "segment":
        pairs = list(zip(got["feats"], want["feats"])) + [(got["proto"], want["proto"], BLOCK_NORM)]
    elif task == "classify":
        pairs = [(got, want)]
    else:
        pairs = list(zip(got, want))
    for g, w, *gate in pairs:
        w32 = np.asarray(w, np.float32)
        err = _norm_rel(g.float().numpy(), nchw(w32) if w32.ndim == 4 else w32)
        print(f"{task} head output {tuple(g.shape)}: {err:.3g} of the JAX output's norm")
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        assert err <= (gate[0] if gate else GRAPH_NORM)


@pytest.mark.parametrize("task", list(TASKS))
def test_cast_inference_graph_casts_what_cast_inference_params_casts(task, models):
    from bsyolo_tpu.nn.model import cast_inference_params
    from bsyolo_tpu_torch.nn.model import cast_inference_graph, compute_dtype
    from bsyolo_tpu_torch.utils.weights import _flatten, flax_path_to_torch_key

    _, _, variables, port = models[task]
    want = {flax_path_to_torch_key(c, path) for c, tree in cast_inference_params(variables).items()
            for path, leaf in _flatten(tree) if leaf.dtype == jnp.bfloat16}
    half = cast_inference_graph(port.model)
    tensors = dict(itertools.chain(half.named_parameters(), half.named_buffers()))
    got = {n for n, t in tensors.items() if t.dtype == torch.bfloat16}
    extra = got - want
    print(f"{task}: {len(want)} tensors cast by both; the port also stores {len(extra)} biases in bfloat16")
    assert compute_dtype(half) == torch.bfloat16 and compute_dtype(port.model) == torch.float32
    assert got >= want and all(n.endswith(".bias") and tensors[n].ndim == 1 for n in extra)
    head = f"model.{len(port.spec.layers) - 1}"
    key = {"segment": f"{head}.proto.upsample.weight", "classify": f"{head}.linear.weight"}.get(task)
    if key:  # the layers this slice gave a compute dtype
        assert key in got and tensors[key.replace("weight", "bias")].dtype == torch.bfloat16


# --- the amp step ---------------------------------------------------------------------------------


def _jax_criterion(task, spec):
    from bsyolo_tpu.losses.classify import classification_loss
    from bsyolo_tpu.losses.obb import obb_loss
    from bsyolo_tpu.losses.pose import pose_loss
    from bsyolo_tpu.losses.segment import segmentation_loss

    if task == "segment":
        return lambda o, b, ls, lc: segmentation_loss(o, b["cls"], b["bboxes"], b["mask"], b["masks"], ls, lc,
                                                      nm=spec.head.args[1])
    if task == "pose":
        return lambda o, b, ls, lc: pose_loss(o, b["cls"], b["bboxes"], b["mask"], b["keypoints"], ls, lc,
                                              kpt_shape=tuple(spec.kpt_shape))
    if task == "obb":
        return lambda o, b, ls, lc: obb_loss(o, b["cls"], b["rboxes"], b["mask"], ls, lc)
    return lambda o, b, ls, lc: classification_loss(o, b["cls"], ls, lc)


def _step_batch(task, nc):
    """A seeded batch of 2 (segment at 96 px: the JAX mask loss takes its 100 anchors with top_k)."""
    if task in ("segment", "pose"):
        return task_batch(40, 2, 96 if task == "segment" else IMG, 6, nc, task)
    rng = np.random.default_rng(41)
    if task == "classify":
        return {"img": rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32),
                "cls": rng.integers(0, nc, 4).astype(np.int32)}
    rb = np.concatenate([rng.uniform(0.25, 0.75, (2, 6, 2)), rng.uniform(0.1, 0.4, (2, 6, 1)),
                         rng.uniform(0.05, 0.2, (2, 6, 1)), rng.uniform(-0.7, 2.3, (2, 6, 1))], -1)
    return {"img": rng.integers(0, 255, (2, IMG, IMG, 3), dtype=np.uint8),
            "cls": rng.integers(0, nc, (2, 6)).astype(np.int32), "rboxes": rb.astype(np.float32),
            "mask": (rng.uniform(0, 1, (2, 6)) < 0.8).astype(np.float32)}


@pytest.mark.parametrize("task", list(TASKS))
def test_amp_step_matches_jax(task, models):
    """One SGD step of each package's amp graph from the same weights and batch."""
    from bsyolo_tpu.engine.optim import OptimConfig as JOpt
    from bsyolo_tpu.engine.train_step import StepConfig as JStep, init_train_state as jinit, make_train_step as jmake
    from bsyolo_tpu.losses import DetectionLossConfig as JLoss
    from bsyolo_tpu.nn.model import DetectionGraph

    from bsyolo_tpu_torch.engine.optim import OptimConfig
    from bsyolo_tpu_torch.engine.train_step import StepConfig, init_train_state, make_train_step, task_criterion
    from bsyolo_tpu_torch.losses import DetectionLossConfig
    from bsyolo_tpu_torch.nn.model import build_model

    _, spec, v, _ = models[task]
    batch = _step_batch(task, spec.nc)
    b = len(batch["img"])
    common = dict(batch_size=b, nb=5, nw=2, use_adamw=False, weight_decay=0.0005)
    okw = dict(name="SGD", lr0=0.01, epochs=4, nbs=b, warmup_bias_lr=0.1)
    strides = spec.head_strides if task != "classify" else (8,)
    pm = build_model(port_spec(_yaml(task)), "cpu", dtype=torch.bfloat16)
    pm = port_module_from_jax(pm, v)
    criterion, names = task_criterion(pm.spec)
    jcfg = JStep(loss=JLoss(nc=spec.nc, strides=strides), optim=JOpt(**okw), **common)
    jstep = jmake(DetectionGraph(spec, dtype=jnp.bfloat16), jcfg, criterion=_jax_criterion(task, spec),
                  item_names=names)
    jstate = jinit({k: jax.tree_util.tree_map(jnp.asarray, x) for k, x in v.items()}, jcfg)
    pcfg = StepConfig(loss=DetectionLossConfig(nc=spec.nc, strides=strides), optim=OptimConfig(**okw), **common)
    pstate, pstep = init_train_state(pm, pcfg), make_train_step(pm, pcfg, criterion, names)
    out_dtypes = []
    pm.model[-1].register_forward_hook(lambda m, a, out: out_dtypes.append(
        (out["proto"] if isinstance(out, dict) else out if task == "classify" else out[0]).dtype))
    jstate, jmet = jstep(jstate, {k: jnp.asarray(x) for k, x in batch.items()})
    pb = {k: torch.from_numpy(nchw(x) if k == "img" else x) for k, x in batch.items()}
    pb["cls"] = pb["cls"].long()
    pstate, pmet = pstep(pstate, pb)
    rel = {k: abs(float(pmet[k]) - float(jmet[k])) / max(abs(float(jmet[k])), 1e-12) for k in ("loss", *names)}
    print(f"amp step {task}: loss items relative to JAX's {({k: f'{r:.3g}' for k, r in rel.items()})}")
    assert out_dtypes == [torch.bfloat16] and int(pmet["updated"]) == 1
    assert all(p.dtype == torch.float32 for p in pstate.params.values())
    assert all(t.dtype == torch.float32 for t in itertools.chain(pstate.ema_params.values(), pstate.slot0.values(),
                                                                 pstate.batch_stats.values()))
    assert max(rel.values()) <= AMP_LOSS_RTOL


@pytest.mark.parametrize("task", ["segment", "pose"])
def test_task_losses_ignore_assigner_bf16_as_jax(task, models):
    """``assigner_bf16=True`` acts on the detection loss only: JAX's Segment and Pose losses never pass
    it to the assigner, so they rank in float32 with it on. The same float32 head maps and batch: the
    port's items with it on equal its items with it off, and are JAX's with it on within ``LOSS_RTOL``
    (tests/test_torch_segment.py's loss gate)."""
    from bsyolo_tpu.losses.detect import DetectionLossConfig as JC, init_loss_state as jinit

    from bsyolo_tpu_torch.engine.train_step import task_criterion
    from bsyolo_tpu_torch.losses import DetectionLossConfig, init_loss_state

    jm, spec, v, port = models[task]
    batch = _step_batch(task, spec.nc)
    x = batch["img"].astype(np.float32) / 255
    jout = jm.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        pout = port.model(torch.from_numpy(nchw(x)))
    _, want, _ = _jax_criterion(task, spec)(jout, {k: jnp.asarray(a) for k, a in batch.items()}, jinit(),
                                            JC(nc=spec.nc, strides=spec.head_strides, assigner_bf16=True))
    criterion, _ = task_criterion(port.model.spec)
    pb = {k: torch.from_numpy(a).long() if k == "cls" else torch.from_numpy(a) for k, a in batch.items() if k != "img"}
    on, off = (criterion(pout, pb, init_loss_state(), DetectionLossConfig(nc=spec.nc, strides=spec.head_strides,
                                                                          assigner_bf16=flag))[1]
               for flag in (True, False))
    print(f"{task} loss items, assigner_bf16 on / off / JAX on: {on.tolist()} / {off.tolist()} / "
          f"{np.asarray(want).tolist()}")
    assert torch.equal(on, off)
    np.testing.assert_allclose(on.numpy(), np.asarray(want), rtol=LOSS_RTOL, atol=1e-6)


@pytest.mark.parametrize("task", list(TASKS))
def test_train_defaults_to_amp_on_every_task(task, tmp_path):
    """``YOLO(...).train()`` without ``amp=``: the trainer builds the task's bf16 graph, steps it, and the
    facade keeps it in eval mode with float32 weights."""
    from bsyolo_tpu_torch import YOLO
    from bsyolo_tpu_torch.nn.model import compute_dtype

    if task == "classify":
        data = write_cls_dataset(tmp_path / "ds", nc=2, n_train=4, n_val=2, size=32)
    elif task == "obb":
        data = write_obb_dataset(tmp_path / "ds", n_train=4, n_val=2)
    else:
        data = write_task_dataset(tmp_path / "ds", task, n_train=4, n_val=2, nc=1 if task == "pose" else 2)
    m = YOLO(_yaml(task), device="cpu")
    m.train(data=str(data), epochs=1, imgsz=32 if task == "classify" else IMG, batch=4, nbs=4, workers=0,
            plots=False, project=str(tmp_path / "runs"), name="amp")
    assert m.trainer.args.amp is True and compute_dtype(m.trainer.model) == torch.bfloat16
    assert compute_dtype(m.model) == torch.bfloat16 and not m.model.training
    assert all(p.dtype == torch.float32 for p in m.model.parameters())
    assert m.trainer.state.step >= 1 and all(torch.isfinite(p).all() for p in m.trainer.state.ema_params.values())


# --- predict(half=True) and val(half=True) ------------------------------------------------------


def _frames():
    rng = np.random.default_rng(50)
    return [rng.integers(0, 256, (48, 64, 3), dtype=np.uint8), rng.integers(0, 256, (64, 56, 3), dtype=np.uint8)]


def _jax_facade(task, models):
    from bsyolo_tpu import YOLO as JaxYOLO

    jy = JaxYOLO(_yaml(task))
    jy.variables = models[task][2]
    return jy


def _pairs(got, want, angle: bool, same=None):
    """Rows of ``got`` paired one to one with ``want``'s (same class, box within MATCH_PX, score
    within MATCH_SCORE, angle within MATCH_ANGLE for rotated rows, ``same(i, j)`` for the row's
    mask or keypoints, the closest score first): [(i, j), ...]. Random weights clip many boxes to
    the frame alike, so the payload, not the box, tells such rows apart."""
    free = np.ones(len(want), bool)
    out = []
    for i, row in enumerate(got):
        ok = (free & (want[:, 5] == row[5]) & (np.abs(want[:, 4] - row[4]) <= MATCH_SCORE)
              & (np.abs(want[:, :4] - row[:4]).max(1) <= MATCH_PX))
        if angle:
            ok &= np.abs(want[:, 6] - row[6]) <= MATCH_ANGLE
        cand = [j for j in np.flatnonzero(ok) if same is None or same(i, j)]
        if cand:
            j = cand[int(np.argmin(np.abs(want[cand, 4] - row[4])))]
            free[j] = False
            out.append((i, j))
    return out


def _payload(task, g, w):
    """The predicate that a row's mask (pixels equal in MASK_AGREE of the frame) or keypoints (within
    MATCH_PX) match, or None."""
    if task == "segment":
        gm, wm = g.masks.data, np.asarray(w.masks.data)
        return lambda i, j: (gm[i] == wm[j]).mean() >= MASK_AGREE
    if task == "pose":
        gk, wk = g.keypoints.data, np.asarray(w.keypoints.data)
        return lambda i, j: np.abs(gk[i][..., :2] - wk[j][..., :2]).max() <= MATCH_PX
    return None


@pytest.mark.parametrize("task", list(TASKS))
def test_predict_half_matches_jax(task, models):
    port, jy = models[task][3], _jax_facade(task, models)
    frames = _frames()
    kw = dict(imgsz=IMG, conf=0.001, iou=1.0, batch=2)
    got, want = port.predict(frames, half=True, **kw), jy.predict(frames, half=True, **kw)
    f32 = port.predict(frames, **kw)
    assert port._half is not None
    for g, w, f in zip(got, want, f32):
        if task == "classify":
            gp, wp = g.probs.data, np.asarray(w.probs.data)
            diff = float(np.abs(gp - wp).max())
            print(f"classify probabilities: {diff:.3g} from JAX's, {np.abs(gp - f.probs.data).max():.3g} from float32")
            assert diff <= PROB_ATOL and not np.array_equal(gp, f.probs.data)
            continue
        gd = g.obb.data if task == "obb" else g.boxes.data
        wd = np.asarray(w.obb.data if task == "obb" else w.boxes.data)
        fd = f.obb.data if task == "obb" else f.boxes.data
        frac = len(_pairs(gd, wd, task == "obb", _payload(task, g, w))) / max(len(gd), len(wd), 1)
        print(f"predict(half=True) {task}: paired {frac:.4f} of {len(gd)} rows (JAX {len(wd)}), with their "
              f"{ {'segment': 'masks', 'pose': 'keypoints'}.get(task, 'angles')}")
        assert len(gd) > 10 and frac >= MATCH_MIN
        assert gd.shape != fd.shape or not np.allclose(gd, fd)  # the bf16 graph ran


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """task -> (best.ckpt of the tiny graph trained in float32 on a set that is its own val split, its
    data), trained on first use."""
    root, done = tmp_path_factory.mktemp("task_bf16"), {}

    def get(task):
        if task not in done:
            done[task] = trained_task_checkpoint(root / task, task, _yaml(task), epochs=60)
        return done[task]

    return get


def _jax_from_ckpt(task, best):
    from bsyolo_tpu import YOLO as JaxYOLO
    from bsyolo_tpu.engine.trainer import load_checkpoint as jax_load

    jy = JaxYOLO(_yaml(task))
    payload, _ = jax_load(best)
    jy.variables = {"params": payload["ema_params"], "batch_stats": payload["batch_stats"]}
    return jy


@pytest.mark.parametrize("task", list(TASKS))
def test_val_half_matches_jax(task, trained):
    """``YOLO(best.ckpt).val(half=True)`` of both packages on trained weights."""
    from bsyolo_tpu_torch import YOLO

    best, data = trained(task)
    port, jy = YOLO(best, device="cpu"), _jax_from_ckpt(task, best)
    got = port.val(data=str(data), batch=4, imgsz=IMG, half=True).results_dict
    f32 = port.val(data=str(data), batch=4, imgsz=IMG).results_dict
    if task == "classify":  # the JAX facade's classify val runs float32 whatever half says
        from bsyolo_tpu.data.classify import ClassificationDataset, ClassifyLoader
        from bsyolo_tpu.engine.classify import ClassificationValidator

        model, variables = jy._bf16_graph(IMG)
        ds = ClassificationDataset(Path(data) / "val", imgsz=IMG, augment=False)
        want = ClassificationValidator(model)(variables, ClassifyLoader(ds, 4, shuffle=False, drop_last=False))
        want, main = want.results_dict, "metrics/accuracy_top1"
    else:
        want, main = jy.val(data=str(data), batch=4, imgsz=IMG, half=True).results_dict, "metrics/mAP50(B)"
    print(f"val(half=True) {task}: port {got}; JAX {want}; port float32 {f32}")
    assert got.keys() == want.keys() and port._half is not None and float(want[main]) > 0.5
    for k in want:  # a Segment or Pose fitness sums the box and the mask or keypoint fitness: twice the bound
        bound = 2 * VAL_ATOL if k == "fitness" and task in ("segment", "pose") else VAL_ATOL
        assert abs(float(got[k]) - float(want[k])) <= bound, k
