"""Graph-walking detection model (counterpart of ``bsyolo_tpu/nn/model.py``).

``DetectionGraph`` runs a parsed ``ModelSpec`` layer by layer, keeping the
outputs the save-list names for later layers. Its layers live in
``self.model``, an ``nn.ModuleList``, so parameter keys read
``model.{i}.…`` like the reference torch graph.

A YOLO-World graph carries its text, (1, K, 512), as the non-persistent
buffer ``txt_feats`` (``bind_text``; the JAX package's ``TextConditioned``
wrapper): it is not in the ``state_dict``, every engine that runs a graph
runs it with its text, and ``cast_inference_graph``'s copy shares it.

In train mode the walk can recompute its forward in the backward (``remat``,
the JAX step's ``remat_policy``): ``seg`` keeps only each top-level layer's
output and recomputes each run of layers from it (``torch.utils.checkpoint``,
non-reentrant), and ``full`` takes the same path; ``light`` keeps everything
autograd keeps but those outputs, which the backward makes again from their
last op's saved input. A recomputed forward draws what the first drew from the
graph's explicit generators and leaves the BatchNorm statistics as the first
left them.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bsyolo_tpu_torch.nn import modules as M
from bsyolo_tpu_torch.nn import modules_nas as NAS
from bsyolo_tpu_torch.nn import transformer as T
from bsyolo_tpu_torch.nn.heads import OBB, Classify, Detect, Pose, Segment, WorldDetect, v10Detect
from bsyolo_tpu_torch.nn.parser import TEXT_MODULES, LayerSpec, ModelSpec


def _build_layer(spec: LayerSpec, strides, dropout: float = 0.0, in_ch: Sequence[int] = ()) -> nn.Module:
    """The module of layer ``spec``; ``in_ch`` are the widths of its inputs (the NAS merges take several)."""
    m, a, c1 = spec.module, spec.args, spec.c1

    def opt(i, default):
        return a[i] if len(a) > i else default

    if m == "Conv":
        return M.Conv(c1, a[0], opt(1, 1), opt(2, 1), opt(3, None), opt(4, 1), opt(5, 1), opt(6, True))
    if m == "DWConv":
        return M.DWConv(c1, a[0], opt(1, 1), opt(2, 1), opt(3, 1), opt(4, True))
    if m in ("C3k2", "C3k2_gai"):
        cls = M.C3k2 if m == "C3k2" else M.C3k2_gai
        return cls(c1, a[0], a[1], c3k=opt(2, False), e=opt(3, 0.5), g=opt(4, 1), shortcut=opt(5, True))
    if m == "C2f":
        return M.C2f(c1, a[0], a[1], opt(2, False), opt(3, 1))
    if m == "C3":
        return M.C3(c1, a[0], a[1], opt(2, True))
    if m == "Bottleneck":
        return M.Bottleneck(c1, a[0], opt(1, True))
    if m == "SPPF":
        return M.SPPF(c1, a[0], opt(1, 5))
    if m == "C2PSA":
        return M.C2PSA(c1, a[0], a[1], opt(2, 0.5))
    if m == "SCDown":
        return M.SCDown(c1, a[0], a[1], a[2])
    if m == "MSCAAttention":
        return M.MSCAAttention(a[0])
    if m == "ELA":
        return M.ELA(a[0])
    if m == "C2":
        return M.C2(c1, a[0], a[1], opt(2, True))
    if m == "C2fCIB":
        return M.C2fCIB(c1, a[0], a[1], opt(2, False), opt(3, False))
    if m == "PSA":
        return M.PSA(c1, a[0], opt(1, 0.5))
    if m == "SPP":
        return M.SPP(c1, a[0], tuple(opt(1, (5, 9, 13))))
    if m == "GhostConv":
        return M.GhostConv(c1, a[0], opt(1, 1), opt(2, 1))
    if m == "GhostBottleneck":
        return M.GhostBottleneck(c1, a[0], opt(1, 3), opt(2, 1))
    if m == "C3Ghost":
        return M.C3Ghost(c1, a[0], a[1])
    if m == "RepNCSPELAN4":
        return M.RepNCSPELAN4(c1, a[0], a[1], a[2], opt(3, 1))
    if m == "ELAN1":
        return M.ELAN1(c1, a[0], a[1], a[2])
    if m == "AConv":
        return M.AConv(c1, a[0])
    if m == "ADown":
        return M.ADown(c1, a[0])
    if m == "SPPELAN":
        return M.SPPELAN(c1, a[0], a[1], opt(2, 5))
    if m == "ResNetLayer":  # (c1, c2, s, is_first, n): c1 is the graph's, not the YAML's
        return M.ResNetLayer(c1, a[1], opt(2, 1), opt(3, False), opt(4, 1))
    if m == "HGStem":
        return M.HGStem(c1, a[0], a[1])
    if m == "HGBlock":  # (cm, c2, k, n, light, shortcut)
        return M.HGBlock(c1, a[0], a[1], a[2], a[3], opt(4, False), opt(5, False))
    if m == "RepC3":
        return M.RepC3(c1, a[0], a[1])
    if m == "AIFI":
        return T.AIFI(c1, opt(0, 2048), opt(1, 8))
    if m == "RTDETRDecoder":
        return T.RTDETRDecoder(a[0], tuple(a[1]))
    if m == "ConvTranspose2d":  # a bare transposed conv with a bias, no padding, as the JAX layer
        return M.ConvTranspose2d(c1, a[0], opt(1, 2), opt(2, 2), 0, bias=True)
    if m == "CBLinear":
        return M.CBLinear(c1, a[0], opt(1, 1), opt(2, 1))
    if m == "CBFuse":
        return M.CBFuse(a[0])
    if m == "Identity":
        return nn.Identity()
    if m == "SpaceToDepth":
        return M.SpaceToDepth(opt(0, 2))
    if m == "MaxPool2d":
        return nn.MaxPool2d(a[0], opt(1, a[0]), opt(2, 0))
    if m == "ZeroPad2d":
        return nn.ZeroPad2d(tuple(a[0]))
    if m == "Upsample":
        return nn.Upsample(scale_factor=opt(1, 2), mode=opt(2, "nearest"))
    if m == "Concat":
        return M.Concat(opt(0, 1))
    if m == "Detect":
        return Detect(a[0], a[1], strides, legacy=a[2])
    if m == "Segment":
        return Segment(a[0], a[1], a[2], a[3], strides, legacy=a[4])
    if m == "Pose":
        return Pose(a[0], a[1], a[2], strides, legacy=a[3])
    if m == "OBB":
        return OBB(a[0], a[1], a[2], strides, legacy=a[3])
    if m == "v10Detect":
        return v10Detect(a[0], a[1], strides)
    if m == "Classify":
        return Classify(c1, a[0], dropout)
    if m == "C2fAttn":  # (c2, n, ec, nh)
        return M.C2fAttn(c1, a[0], a[1], a[2], a[3])
    if m == "ImagePoolingAttn":  # (ec, in_ch)
        return M.ImagePoolingAttn(a[0], tuple(a[1]))
    if m == "WorldDetect":  # (nc, embed, with_bn, in_ch, legacy)
        return WorldDetect(a[0], tuple(a[3]), strides, a[1], a[2])
    if m == "Index":
        return M.Index()
    if m == "YoloNASStem":
        return NAS.YoloNASStem(c1, a[0])
    if m == "YoloNASStage":  # (c2, n, hidden, concat_intermediates)
        return NAS.YoloNASStage(c1, a[0], a[1], a[2], opt(3, False))
    if m == "NASUpMerge":  # (c2, n, hidden) on (pre, skip1, skip2)
        return NAS.NASUpMerge(tuple(in_ch), a[0], a[1], a[2])
    if m == "NASDown":  # (c2, n, hidden) on (x, skip)
        return NAS.NASDown(tuple(in_ch), a[0], a[1], a[2])
    if m == "NASDetect":  # (nc, inter, in_ch)
        return NAS.NASDetect(a[0], tuple(a[-1]), strides, tuple(a[1]) if len(a) > 2 else (64, 128, 256))
    raise NotImplementedError(f"module {m} has no layer constructor in DetectionGraph")


class DetectionGraph(nn.Module):
    """Executes a ModelSpec; the output is the head's: a list of raw per-level maps (Detect,
    Pose, OBB), ``{"feats": levels, "proto": prototypes}`` (Segment), ``{"one2many": levels,
    "one2one": levels}`` (v10Detect), the decoder's dict (RTDETRDecoder, ``nn/transformer.py``)
    or (B, nc) class logits (Classify). A layer of several
    inputs (Concat, CBFuse) takes them as a list; CBLinear's output is a tuple of taps. Every
    ``Conv`` takes the spec's activation (``act``)."""

    def __init__(self, spec: ModelSpec):
        super().__init__()
        self.spec = spec
        layers = []
        for layer in spec.layers:
            if layer.n > 1:  # plain repeated modules become a Sequential, children 0..n-1
                layers.append(nn.Sequential(*(_build_layer(layer, spec.head_strides) for _ in range(layer.n))))
            else:
                in_ch = tuple(spec.layers[layer.i - 1 if j == -1 else j].c2 for j in layer.f) if layer.i else ()
                layers.append(_build_layer(layer, spec.head_strides, spec.dropout, in_ch))
        self.model = nn.ModuleList(layers)
        M.set_activation(self, spec.act)
        self.world = spec.world
        if self.world:  # the JAX graph's placeholder text: not a parameter, replaced by bind_text
            placeholder = np.random.default_rng(0).normal(size=(1, spec.nc, 512)).astype(np.float32)
            self.register_buffer("txt_feats", torch.from_numpy(placeholder), persistent=False)

    def forward(self, x: torch.Tensor, embed: Sequence[int] = (), targets: Optional[Dict[str, torch.Tensor]] = None,
                remat=None):
        """The head's list of per-level maps; with ``embed`` (layer indices), the global-average-pooled
        outputs of those layers concatenated over channels, (B, C1 + C2 + ...), the walk stopping at the
        last of them (``bsyolo_tpu/nn/model.py`` embed). ``targets`` (the padded labels ``cls``,
        ``bboxes``, ``mask``) go to an RTDETRDecoder head, whose train mode builds denoising queries
        from them. A YOLO-World graph reads its ``txt_feats`` (B or 1, K, 512; ``bind_text``), in the
        dtype of the map that meets it first: C2fAttn takes the running text, ImagePoolingAttn
        replaces it, WorldDetect takes the text as it came in. ``remat`` (``remat_mode``'s values)
        recomputes the forward in the backward, in train mode with gradients on."""
        mode = remat_mode(remat) if self.training and torch.is_grad_enabled() else None
        if mode is None:
            return self._walk(x, targets, embed)
        if mode == "light":
            with _light_saves() as boundary:
                return self._walk(x, targets, boundary=boundary)
        # full takes seg's path, which on eager PyTorch holds what JAX's full holds at its peak (the runs'
        # boundaries and one run's activations): a checkpoint of the whole walk around the runs measured the
        # same peak memory on the card and one more forward of time (PERF.md)
        return self._walk(x, targets, segments=_Replay(self))

    def _layer(self, layer: LayerSpec, m: nn.Module, x, saved: Dict[int, torch.Tensor], text, targets):
        """One layer of the walk: (its output, the running text (txt, ori_txt))."""
        txt, ori_txt = text
        if layer.module in TEXT_MODULES:
            if ori_txt is None:  # the JAX graph casts the text to its compute dtype once
                txt = ori_txt = txt.to(x.dtype)
            feats = [x if j == -1 else saved[j] for j in layer.f]
            if layer.module == "C2fAttn":
                x = m(feats[0], txt)
            elif layer.module == "ImagePoolingAttn":
                x = txt = m(feats, txt)
            else:
                x = m(feats, ori_txt)
        elif layer.module == "RTDETRDecoder":
            x = m([x if j == -1 else saved[j] for j in layer.f], targets=targets)
        elif len(layer.f) > 1:
            x = m([x if j == -1 else saved[j] for j in layer.f])
        else:
            x = m(x if layer.f[0] == -1 else saved[layer.f[0]])
        return x, (txt, ori_txt)

    def _walk(self, x: torch.Tensor, targets=None, embed: Sequence[int] = (), boundary=None, segments=None):
        """Run the layers. ``boundary(output)`` is called after each layer whose output the JAX walk tags as
        a remat boundary (``is_boundary``); with ``segments`` (a ``_Replay``) each run of layers up to and
        including such a layer, the head's run last, is checkpointed on its own (remat ``seg``)."""
        saved: Dict[int, torch.Tensor] = {}
        save = set(self.spec.save)
        pooled: List[torch.Tensor] = []
        last = max(embed) if embed else -1
        text = (None, None)
        if self.world:
            text = (self.txt_feats.expand(x.shape[0], -1, -1) if self.txt_feats.shape[0] == 1 else self.txt_feats,
                    None)
        if segments is not None:
            return self._walk_segments(x, targets, saved, text, segments)
        for layer, m in zip(self.spec.layers, self.model):
            x, text = self._layer(layer, m, x, saved, text, targets)
            if layer.i in save:
                saved[layer.i] = x
            if boundary is not None and is_boundary(layer, x):
                boundary(x)
            if layer.i in embed:
                pooled.append(x.mean((2, 3)) if x.ndim == 4 else x.reshape(x.shape[0], -1))
                if layer.i == last:
                    return torch.cat(pooled, 1)
        return x

    def _walk_segments(self, x, targets, saved, text, replay: "_Replay"):
        """The walk as checkpointed runs of layers, each ending at a boundary layer (or the head): a
        run keeps its inputs (the previous boundary, the saved outputs it reads, the text) and
        recomputes the rest in the backward."""
        layers = list(zip(self.spec.layers, self.model))
        save = set(self.spec.save)
        start = 0
        while start < len(layers):
            end = start
            while end < len(layers) - 1 and not is_boundary_module(layers[end][0]):
                end += 1
            run = layers[start : end + 1]
            reads = sorted({j for layer, _ in run for j in layer.f if j != -1 and j < run[0][0].i})
            produced = [layer.i for layer, _ in run if layer.i in save]

            def seg_fn(xin, txt, ori_txt, *inputs, run=run, reads=reads, produced=produced):
                local = dict(zip(reads, inputs))
                t = (txt, ori_txt)
                for layer, m in run:
                    xin, t = self._layer(layer, m, xin, local, t, targets)
                    if layer.i in save:
                        local[layer.i] = xin
                return (xin, *t, *(local[i] for i in produced))

            outs = checkpoint(replay.wrap(seg_fn), x, *text, *(saved[j] for j in reads), use_reentrant=False)
            x, text = outs[0], (outs[1], outs[2])
            saved.update(zip(produced, outs[3:]))
            start = end + 1
        return x


_REARRANGE = ("Concat", "Upsample", "Index", "Identity", "SpaceToDepth", "ZeroPad2d")


def is_boundary_module(layer: LayerSpec) -> bool:
    """Whether the JAX walk may tag ``layer``'s output ``bs_seg`` (``bsyolo_tpu/nn/model.py``): every
    layer but the pure rearrangements, where its output is a 4-D map."""
    return layer.module not in _REARRANGE


def is_boundary(layer: LayerSpec, out) -> bool:
    """Whether the JAX walk tags this output of ``layer`` as a remat boundary: a 4-D map of a layer
    that is not a pure rearrangement."""
    return is_boundary_module(layer) and torch.is_tensor(out) and out.ndim == 4


def remat_mode(remat) -> Optional[str]:
    """The ``remat`` setting -> None (off), ``"full"``, ``"seg"`` or ``"light"``, as the JAX step's
    ``remat_policy`` reads it: False, '0', 'off', 'none' or '' is off; True or 'full' (in JAX: save
    nothing but the input; here ``seg``'s path); 'seg' only each top-level layer's output; 'light'
    everything but those."""
    if not remat:
        return None
    mode = remat.lower() if isinstance(remat, str) else "full"
    if mode in ("0", "false", "off", "none", ""):
        return None
    if mode in ("full", "true", "1"):
        return "full"
    if mode in ("seg", "light"):
        return mode
    raise ValueError(f"remat={remat!r}: expected False/'0'/'off', True/'full', 'seg', or 'light'")


@contextlib.contextmanager
def frozen_batch_stats(model: nn.Module):
    """While open, ``model``'s BatchNorm layers normalize train-mode batches by their own statistics
    and update no running statistics (a recomputed forward)."""
    bns = [m for m in model.modules() if isinstance(m, M.BatchNorm2d)]
    for m in bns:
        m.frozen_stats = True
    try:
        yield
    finally:
        for m in bns:
            m.frozen_stats = False


class _Replay:
    """Wraps the functions that ``checkpoint`` runs twice: the first run of each keeps the states of
    the graph's explicit generators (Classify's dropout, RT-DETR's denoising draws), and the second,
    the recomputation in the backward, starts from them again (``checkpoint`` restores only the
    default generators) with the BatchNorm statistics frozen, so it computes what the first did and
    updates nothing twice."""

    def __init__(self, model: nn.Module):
        self.model = model
        self.generators = [m.generator for m in model.modules() if getattr(m, "generator", None) is not None]

    def wrap(self, fn):
        states = []

        def run(*args):
            if not states:
                states.append([g.get_state() for g in self.generators])
                return fn(*args)
            for g, st in zip(self.generators, states[0]):
                g.set_state(st)
            with frozen_batch_stats(self.model):
                return fn(*args)

        return run


# remat light: the last op of a boundary output -> the output made again from what that op saved
_REMAKE = {
    "SiluBackward0": lambda node: F.silu(node._saved_self),
    "HardswishBackward0": lambda node: F.hardswish(node._saved_self),
    "MishBackward0": lambda node: F.mish(node._saved_self),
    "LeakyReluBackward0": lambda node: F.leaky_relu(node._saved_self, node._saved_negative_slope),
    "GeluBackward0": lambda node: F.gelu(node._saved_self, approximate=node._saved_approximate),
}


class _Remade(NamedTuple):
    """What an op saves in place of a boundary output under remat ``light``: that output's last op."""

    remake: Callable
    node: object


@contextlib.contextmanager
def _light_saves():
    """Remat ``light`` (JAX's ``save_anything_except_these_names('bs_seg')``), while open: autograd saves
    what it saves, except the boundary outputs passed to the yielded function, which an op that saves one
    keeps as its last op (an activation, ``_REMAKE``), run again on that op's saved input when the backward
    reads it. Nothing else holds them, so they are freed after the forward. An output whose last op saved
    it (ReLU) or nothing (an add) is kept as it is."""
    outputs: Dict[int, torch.Tensor] = {}

    def register(out: torch.Tensor) -> None:
        if type(out.grad_fn).__name__ in _REMAKE:
            outputs[id(out)] = out

    def pack(t: torch.Tensor):
        return _Remade(_REMAKE[type(t.grad_fn).__name__], t.grad_fn) if outputs.get(id(t)) is t else t

    def unpack(saved):
        return saved.remake(saved.node) if isinstance(saved, _Remade) else saved

    with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
        try:
            yield register
        finally:
            outputs.clear()


def bind_text(model: DetectionGraph, text) -> DetectionGraph:
    """Bind a YOLO-World graph to ``text``, (K, E) or (1, K, E) rows, as its ``txt_feats`` (float32, on the
    graph's device), the port's counterpart of the JAX package's ``TextConditioned``; returns ``model``."""
    if not getattr(model, "world", False):
        raise TypeError("bind_text takes a YOLO-World graph (C2fAttn, ImagePoolingAttn or WorldDetect layers)")
    t = torch.as_tensor(np.asarray(text, np.float32) if not torch.is_tensor(text) else text, dtype=torch.float32)
    model.txt_feats = (t[None] if t.ndim == 2 else t).to(model.txt_feats.device)
    return model


COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def build_model(spec: ModelSpec, device, seed: int = 0, dtype: torch.dtype = torch.float32) -> DetectionGraph:
    """Build the graph with weights drawn from a seeded ``torch.Generator`` on the
    host, then move it to ``device`` in eval mode: the same seed gives the same
    weights on every device. ``dtype`` is the compute dtype (``set_compute_dtype``);
    the parameters are float32 either way."""
    model = DetectionGraph(spec)
    g = torch.Generator().manual_seed(seed)
    M.reset_parameters(model, g)
    if isinstance(model.model[-1], (Detect, v10Detect)):
        model.model[-1].bias_init()
    set_compute_dtype(model, dtype)
    return model.to(device).eval()


def set_compute_dtype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Run every convolution and linear layer of ``model`` in ``dtype``, float32 or bfloat16: the JAX
    package's ``DetectionGraph(dtype=...)``, whatever the head. Parameters, gradients and BatchNorm
    statistics stay float32; the head's levels, Segment's prototypes and Classify's logits come out in
    ``dtype``. Returns ``model``."""
    if dtype not in COMPUTE_DTYPES:
        raise TypeError(f"compute dtype must be float32 or bfloat16, got {dtype}")
    for m in M.cast_convs(model):
        m.compute_dtype = None if dtype == torch.float32 else dtype  # float32: the weights' own dtype, no cast
    return model


def compute_dtype(model: nn.Module) -> torch.dtype:
    """The compute dtype of ``model``'s convolutions."""
    conv = M.cast_convs(model)[0]
    return conv.compute_dtype or conv.weight.dtype


def cast_inference_graph(model: nn.Module, dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """An inference copy of ``model`` computing in ``dtype`` with the weights and biases of its
    convolutions, Proto's transposed convolution and Classify's linear layer stored in ``dtype``
    once (the counterpart of the JAX package's ``cast_inference_params``, which casts every float32
    weight of rank 2 or more: weights cast once, not per call). Every other tensor is
    shared with ``model``: BatchNorm's statistics and affine parameters and ELA's fusion
    weights stay float32, so the copy sees later updates of them; a change of the
    convolution weights needs a new copy. The int8 mode and its scales are copied; hooks
    registered on ``model`` are not."""
    shared = {id(t): t for t in itertools.chain(model.parameters(), model.buffers())}
    graph = copy.deepcopy(model, shared)
    for m in M.cast_convs(graph):
        m.weight = nn.Parameter(m.weight.detach().to(dtype), requires_grad=False)
        if m.bias is not None:
            m.bias = nn.Parameter(m.bias.detach().to(dtype), requires_grad=False)
    for m in graph.modules():
        m._forward_hooks.clear()
        m._forward_pre_hooks.clear()
        if isinstance(m, M.Conv):
            m._int8_cache = None
            m._calib_hook = None
    return set_compute_dtype(graph, dtype).eval()


def count_params(model: nn.Module) -> int:
    """The parameters of ``model``, as the JAX package's ``count_params`` counts its ``params``
    collection (BatchNorm's running statistics are buffers, not counted)."""
    return sum(p.numel() for p in model.parameters())
