"""Pose train, eval and inference steps, on one device or data-parallel
over a mesh, and the device-side metric accumulator.

Port of ``stlpose_tpu/parallel/steps.py`` (``make_train_step``,
``make_eval_step``, ``make_infer_fn``, ``make_eval_decode_step``,
``_pck_from_heatmaps``, ``MetricAccumulator``). One train step is HRNet's
train-mode forward, the masked MSE (optionally weighted by the perceptual
loss), autograd's backward, the optimizer update and the PCK metric, whose
two peak searches run on K1.
The eval and inference functions run under ``torch.no_grad()``; with
flip-TTA the mirrored crops (``torch.flip`` of the width axis) go into the
same batch for one forward of 2N crops, and the two halves are combined
in the model's (N, H, W, J) view, as the reference does. That view lies
on NCHW memory and the combine's elementwise ops keep that layout, so the
(N, J, H, W) view that the loss, PCK and decode read is contiguous maps:
K1's bulk kernel. A step switches the model's mode only when it is not
already in the one it needs (eval for the eval functions, train for the
train step): ``model.eval()`` or ``model.train()`` walks HRNet-W32's
~1,000 modules, some milliseconds of host time before the first launch of
every call.
Nothing is fetched to the host: the metrics stay device tensors, and PCK
makes its (H, W) divisor on the device, with no copy from the host.

On one CUDA device the train step replays a CUDA graph: forward, loss,
backward and the Adam update, ~7,500 kernels for HRNet-W32 at B = 32
(capturable Adam's bias corrections take ~1,750 of them), become one
``CUDAGraph.replay`` a step (``make_train_step``). The CPU, a mesh, an
optimizer with no capturable mode and each batch signature's first step
run eagerly. An eager train step is the span ``train.step``
(``utils/profiling.py``) around ``train.forward`` (model, loss,
perceptual weighting), ``train.backward`` (``zero_grad`` and autograd),
``train.metrics`` (PCK) and ``train.update`` (the gradients' all-reduce on
a mesh, ``optimizer.step``); a graph step is ``train.step`` around
``train.capture`` (a signature's capture), ``train.replay`` (the batch
copied into the graph's inputs, the replay) and ``train.metrics``.

With a ``mesh`` of W ranks (``parallel/mesh.py``) each rank holds the same
model and optimizer (the reference's replicated state) and steps on its
rows of the global batch. The train step takes BatchNorm's statistics over
the global batch (``FlaxBatchNorm2d`` on the mesh's group), sums the
gradients and the metrics in one flattened all-reduce and divides the
gradients by W, so every rank takes the same optimizer step; the loss
comes back as the mean of the ranks' means (exact: the MSE is a plain
mean over equal shards) and the PCK counts summed, on every rank (the
reference's replicated outputs). The eval steps' metrics are reduced the
same way; heatmaps and keypoints stay this rank's rows. A perceptual
weighting takes the global batch's mean perceptual loss.

The inference functions close over the model, which holds its weights:
``make_infer_fn`` and ``make_eval_decode_step`` return functions of the
batch alone, where the reference's take the train state first.
"""

from __future__ import annotations

import warnings
from typing import Callable

import torch
import torch.distributed as dist

from stlpose_tpu_torch.models.hrnet import set_batchnorm_group
from stlpose_tpu_torch.ops.decode import decode_heatmaps, heatmap_argmax
from stlpose_tpu_torch.ops.flip import average_flip_tta_nhwc
from stlpose_tpu_torch.parallel.mesh import mesh_group, mesh_size
from stlpose_tpu_torch.train.loss import (apply_perceptual_loss,
                                          person_mse_loss)
from stlpose_tpu_torch.train.state import PoseTrainState
from stlpose_tpu_torch.utils.profiling import span


def _nhwc_to_njhw(hm):
    """(N, H, W, J) model output -> (N, J, H, W) view."""
    return hm.permute(0, 3, 1, 2)


def _pck_from_heatmaps(pred_njhw, target_njhw, thr=0.5):
    """PCK hits and count with the reference's normalisation (the (x, y)
    offset divided by (H, W) / 10), over joints whose target peak lies
    past (1, 1)."""
    H, W = pred_njhw.shape[2], pred_njhw.shape[3]
    pred, _ = heatmap_argmax(pred_njhw)
    gt, _ = heatmap_argmax(target_njhw)
    # [H, W] filled on the device: a list copied from the host would wait
    # for every launch before it
    norm = torch.full((2,), H, dtype=torch.float32, device=pred.device)
    norm[1].fill_(W)
    norm = norm / 10.0
    valid = (gt[..., 0] > 1) & (gt[..., 1] > 1)
    dist = torch.linalg.norm((pred - gt) / norm, dim=-1)
    return ((dist < thr) & valid).sum(), valid.sum()


class MetricAccumulator:
    """Running sums of step metrics on the device: ``update`` only
    enqueues adds (no host sync), ``fetch`` brings the sums to the host
    once. For keys in ``finite_only`` a non-finite value is skipped and the
    finite steps are counted. ``fetch`` returns ``{"n": steps,
    "<k>_sum", "<k>_n", "<k>_mean"}``."""

    def __init__(self, finite_only: tuple = ()):
        self._sums = None
        self._finite_only = tuple(finite_only)

    def update(self, metrics: dict) -> None:
        vals = {k: torch.as_tensor(v).to(torch.float32)
                for k, v in metrics.items()}
        if self._sums is None:
            zero = torch.zeros((), dtype=torch.float32,
                               device=next(iter(vals.values())).device)
            self._sums = {"_n": zero.clone()}
            for k in vals:
                self._sums[k] = zero.clone()
                if k in self._finite_only:
                    self._sums[f"_{k}_finite"] = zero.clone()
        self._sums["_n"] += 1.0
        for k, v in vals.items():
            if k in self._finite_only:
                ok = torch.isfinite(v)
                self._sums[k] += torch.where(ok, v, 0.0)
                self._sums[f"_{k}_finite"] += ok.to(torch.float32)
            else:
                self._sums[k] += v

    @property
    def empty(self) -> bool:
        return self._sums is None

    def fetch(self) -> dict:
        """One host transfer of the running sums."""
        if self._sums is None:
            return {"n": 0.0}
        keys = list(self._sums)
        host = dict(zip(keys, torch.stack([self._sums[k] for k in keys])
                        .tolist()))
        n = host["_n"]
        out = {"n": n}
        for k, v in host.items():
            if k.startswith("_"):
                continue
            denom = host.get(f"_{k}_finite", n)
            out[f"{k}_sum"] = v
            out[f"{k}_n"] = denom
            out[f"{k}_mean"] = v / denom if denom else 0.0
        return out


def use_global_batchnorm(model, group) -> None:
    """Point the model's BatchNorms at ``group`` once (a walk of its
    modules), and again only when the group changes."""
    if getattr(model, "_batchnorm_group", None) is not group:
        set_batchnorm_group(model, group)
        model._batchnorm_group = group


def global_mean(x, group, world: int):
    """A one-element tensor: the mean over the ranks of ``x``'s local
    mean (the global mean of equal shards)."""
    m = torch.as_tensor(x, dtype=torch.float32).mean().reshape(1)
    dist.all_reduce(m, group=group)
    return m / world


def reduce_gradients(params, extras, group, world: int):
    """Sum the parameters' gradients and the scalars ``extras`` over the
    group in one flattened all-reduce; the gradients are divided by
    ``world`` in place (a missing gradient counts as zero). The buffer
    is f32, or the gradients' wider dtype. Returns the summed extras as
    scalars of that dtype."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    dtype = torch.float32
    for g in grads:
        dtype = torch.promote_types(dtype, g.dtype)
    flat = torch.cat([g.reshape(-1).to(dtype) for g in grads] +
                     [torch.as_tensor(e).reshape(1).to(dtype)
                      for e in extras])
    dist.all_reduce(flat, group=group)
    ng = flat.numel() - len(extras)
    flat[:ng] /= world
    off = 0
    for p, g in zip(params, grads):
        n = g.numel()
        p.grad = flat[off:off + n].view_as(g).to(g.dtype)
        off += n
    return list(flat[ng:])


def _reduce_metrics(metrics, group, world: int):
    """Global eval metrics: the mean of the ranks' mean losses and the
    summed PCK counts."""
    flat = torch.stack([metrics[k].to(torch.float32)
                        for k in ("loss", "pck_hit", "pck_cnt")])
    dist.all_reduce(flat, group=group)
    return {"loss": flat[0] / world,
            "pck_hit": flat[1].round().to(metrics["pck_hit"].dtype),
            "pck_cnt": flat[2].round().to(metrics["pck_cnt"].dtype)}


GRAPH_INPUTS = ("image", "target", "target_weight")


def graph_signature(device, group, optimizer, batch):
    """The key under which a train step replays a CUDA graph, or None
    where it runs eagerly: parameters off CUDA, a mesh (``group``: NCCL
    collectives and global BatchNorm), or an optimizer with no capturable
    mode (SGD). The key holds the shapes and dtypes of image, target and
    target_weight, and the shape of perceptual_loss (None: absent)."""
    if (torch.device(device).type != "cuda" or group is not None
            or "capturable" not in optimizer.defaults):
        return None
    perc = batch.get("perceptual_loss")
    return (tuple((tuple(batch[k].shape), batch[k].dtype)
                  for k in GRAPH_INPUTS),
            None if perc is None else tuple(torch.as_tensor(perc).shape))


def graph_route(signature, warm, graphs) -> str:
    """How a step of ``signature`` runs: "eager" (no signature),
    "warm-up" (eager, the signature's first step), "capture" (warm but
    not captured: capture, then replay) or "replay"."""
    if signature is None:
        return "eager"
    if signature in graphs:
        return "replay"
    return "capture" if signature in warm else "warm-up"


def captured_state(state):
    """What a captured step holds by address or bakes in: the model, the
    optimizer, its state dict and state tensors (``load_state_dict``
    replaces them), each param group's settings (the learning rate that
    ``set_current_lr`` changes among them) and the storage of each
    parameter and buffer (BatchNorm's statistics). A graph replays only
    while this compares equal."""
    opt = state.optimizer
    params = [p for g in opt.param_groups for p in g["params"]]
    return (id(state.model), id(opt), id(opt.state),
            [{k: v for k, v in g.items() if k != "params"}
             for g in opt.param_groups],
            [p.data_ptr() for p in params],
            [b.data_ptr() for b in state.model.buffers()],
            [id(t) for p in params for t in opt.state.get(p, {}).values()])


def make_capturable(optimizer) -> None:
    """Adam's capturable mode in every param group (bias corrections from
    a step count on the device), a step count held on the host moved to
    its parameter's device."""
    for group in optimizer.param_groups:
        group["capturable"] = True
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if "step" in st and st["step"].device != p.device:
                st["step"] = st["step"].to(p.device)


class _Captured:
    """One captured step: the graph, its input tensors (the batch is
    copied in before each replay) and its heatmaps and loss."""

    def __init__(self, graph, inputs, pred, loss):
        self.graph, self.inputs, self.pred, self.loss = (graph, inputs,
                                                         pred, loss)

    def replay(self, batch):
        for k, t in self.inputs.items():
            t.copy_(torch.as_tensor(batch[k]))
        self.graph.replay()


class _StepGraphs:
    """The CUDA graphs of one train step function, one a batch signature,
    and the side stream that warms up and captures them."""

    def __init__(self, eager: Callable, perceptual_cfg):
        self.eager = eager
        self.perceptual_cfg = perceptual_cfg
        self.graphs = {}          # signature -> _Captured
        self.warm = set()         # signatures with an eager step behind
        self.held = None          # captured_state the two above belong to
        self.stream = None

    def __call__(self, state, batch, signature, device):
        held = captured_state(state)
        if held != self.held:
            self.graphs.clear()
            self.warm.clear()
        if self.stream is None:
            self.stream = torch.cuda.Stream(device)
        route = graph_route(signature, self.warm, self.graphs)
        if route == "warm-up":
            metrics = self._warm_up(state, batch)
            self.warm.add(signature)
        else:
            if route == "capture":
                with span("train.capture"):
                    self.graphs[signature] = self._capture(state, batch,
                                                           device)
            cap = self.graphs[signature]
            with span("train.replay"):
                cap.replay(batch)
            with span("train.metrics"):
                hit, cnt = _pck_from_heatmaps(cap.pred, cap.inputs["target"])
            state.step += 1
            metrics = {"loss": cap.loss.clone(), "pck_hit": hit,
                       "pck_cnt": cnt}
        if route != "replay":
            self.held = captured_state(state)
        return metrics

    def _warm_up(self, state, batch):
        """The eager step, Adam made capturable, on the capture's stream:
        Adam's moments, cuDNN's plans and the stream's workspaces exist
        before the capture."""
        make_capturable(state.optimizer)
        main = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream), warnings.catch_warnings():
            warnings.filterwarnings(
                "ignore", message="This instance was constructed with "
                "capturable=True")
            metrics = self.eager(state, batch)
        main.wait_stream(self.stream)
        return metrics

    def _capture(self, state, batch, device):
        """Forward, loss, perceptual weighting, backward (into gradients
        the capture allocates) and ``optimizer.step()`` as one graph."""
        inputs = {k: torch.empty_like(batch[k]) for k in GRAPH_INPUTS}
        perc = None
        if self.perceptual_cfg is not None:
            if "perceptual_loss" in batch:
                perc = inputs["perceptual_loss"] = torch.empty(
                    torch.as_tensor(batch["perceptual_loss"]).shape,
                    dtype=torch.float32, device=device)
            else:                 # the eager step's 0.0, made on the card
                perc = torch.zeros((), dtype=torch.float32, device=device)
        model, opt = state.model, state.optimizer
        opt.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self.stream):
            pred = _nhwc_to_njhw(model(inputs["image"]))
            loss = person_mse_loss(pred, inputs["target"],
                                   inputs["target_weight"])
            if self.perceptual_cfg is not None:
                loss = apply_perceptual_loss(self.perceptual_cfg, loss, perc)
            loss.backward()
            opt.step()
        return _Captured(graph, inputs, pred.detach(), loss.detach())


def make_train_step(perceptual_cfg: dict | None = None,
                    mesh=None) -> Callable:
    """step(state, batch) -> metrics: one update of ``state`` in place.

    ``batch`` holds "image" (N, 256, 192, 3), "target" (N, J, 64, 48),
    "target_weight" (N, J) and, with ``perceptual_cfg`` (the experiment
    dict), "perceptual_loss" (N,): with a ``mesh``, this rank's rows.
    Metrics: "loss" (before the update), "pck_hit" and "pck_cnt" of the
    forward's heatmaps, over the global batch: each step's own tensors.

    The step runs eagerly on the CPU, on a mesh (NCCL collectives and
    global BatchNorm) and with an optimizer that has no capturable mode
    (``graph_signature``). On one CUDA device it keeps a CUDA graph per
    batch signature (``graph_route``): the signature's first step runs
    eagerly on a side stream, with the optimizer made capturable
    (``make_capturable``: Adam's bias corrections from a device step
    count); the second captures forward, loss, weighting, backward and
    ``optimizer.step()`` on that stream (same kernels, same order: cuDNN's
    convolutions and BatchNorm, foreach Adam) and replays the capture;
    each later step copies the batch into the graph's inputs and replays.
    PCK runs eagerly on the replay's heatmaps (K1), ``state.step`` and the
    model's mode are set on the host. The graphs are dropped, and the
    next step warms up again, when ``captured_state`` changes: another
    learning rate, ``optimizer.load_state_dict``, parameters or buffers
    moved."""
    group, world = mesh_group(mesh), mesh_size(mesh)

    def step(state: PoseTrainState, batch):
        with span("train.step"):
            if not state.model.training:
                state.model.train()
            device = state.optimizer.param_groups[0]["params"][0].device
            signature = graph_signature(device, group, state.optimizer,
                                        batch)
            if signature is None:
                return _step(state, batch)
            return graphs(state, batch, signature, device)

    def _step(state, batch):
        model = state.model
        if group is not None:
            use_global_batchnorm(model, group)
        with span("train.forward"):
            pred = _nhwc_to_njhw(model(batch["image"]))
            loss = person_mse_loss(pred, batch["target"],
                                   batch["target_weight"])
            if perceptual_cfg is not None:
                perc = batch.get("perceptual_loss", 0.0)
                if group is not None:
                    perc = global_mean(perc, group, world).to(loss.device)
                loss = apply_perceptual_loss(perceptual_cfg, loss, perc)
        with span("train.backward"):
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with span("train.metrics"):
            hit, cnt = _pck_from_heatmaps(pred.detach(), batch["target"])
        loss = loss.detach()
        with span("train.update"):
            if group is not None:
                params = [p for p in model.parameters() if p.requires_grad]
                total, hits, cnts = reduce_gradients(
                    params, [loss, hit, cnt], group, world)
                loss = total / world
                hit = hits.round().to(hit.dtype)
                cnt = cnts.round().to(cnt.dtype)
            state.optimizer.step()
        state.step += 1
        return {"loss": loss, "pck_hit": hit, "pck_cnt": cnt}

    graphs = _StepGraphs(_step, perceptual_cfg)
    return step


def _forward_heatmaps(model, images, flip_tta: bool):
    """Eval-mode forward -> (N, J, H, W) heatmaps; with ``flip_tta`` one
    forward of the crops and their mirror images, combined by
    ``average_flip_tta_nhwc``."""
    if model.training:
        model.eval()
    if not flip_tta:
        return _nhwc_to_njhw(model(images))
    n = images.shape[0]
    out = model(torch.cat([images, torch.flip(images, dims=[2])], dim=0))
    return _nhwc_to_njhw(average_flip_tta_nhwc(out[:n], out[n:]))


def _eval_metrics(pred_njhw, batch, group=None, world: int = 1):
    loss = person_mse_loss(pred_njhw, batch["target"], batch["target_weight"])
    hit, cnt = _pck_from_heatmaps(pred_njhw, batch["target"])
    metrics = {"loss": loss, "pck_hit": hit, "pck_cnt": cnt}
    if group is not None:
        metrics = _reduce_metrics(metrics, group, world)
    return metrics


def make_eval_step(flip_tta: bool = False, mesh=None) -> Callable:
    """step(state, batch) -> (heatmaps (N, J, H, W), metrics): eval-mode
    forward (optionally flip-TTA), loss and PCK. With a ``mesh`` the
    heatmaps are this rank's rows and the metrics global."""
    group, world = mesh_group(mesh), mesh_size(mesh)

    def step(state: PoseTrainState, batch):
        with torch.no_grad():
            pred = _forward_heatmaps(state.model, batch["image"], flip_tta)
            return pred, _eval_metrics(pred, batch, group, world)

    return step


def make_infer_fn(model, flip_tta: bool = True, decode: bool = True,
                  mesh=None) -> Callable:
    """Crops -> heatmaps -> keypoints in source-image pixels.

    Returns fn(images, centers, scales) -> (preds (N, J, 3) [x, y,
    maxval], heatmaps (N, J, H, W)) when ``decode``, else fn(images) ->
    heatmaps. Runs where ``model`` lives; on a ``mesh`` each rank infers
    its own rows (no collective: the reference's data-sharded outputs)."""

    def infer_hm(images):
        with torch.no_grad():
            return _forward_heatmaps(model, images, flip_tta)

    if not decode:
        return infer_hm

    def infer(images, centers, scales):
        with torch.no_grad():
            hm = _forward_heatmaps(model, images, flip_tta)
            preds, maxvals, _ = decode_heatmaps(hm, centers, scales)
            return torch.cat([preds, maxvals[..., None]], dim=-1), hm

    return infer


def make_eval_decode_step(model, flip_tta: bool = True,
                          mesh=None) -> Callable:
    """The evaluator's whole per-batch device work: flip-TTA forward, loss,
    PCK and decoded keypoints from one forward.

    Returns fn(batch) -> (preds (N, J, 3) [x, y, maxval] in source-image
    pixels, metrics); ``batch`` holds image, target, target_weight, center
    and scale as tensors on the model's device. With a ``mesh`` the
    keypoints are this rank's rows and the metrics global."""
    group, world = mesh_group(mesh), mesh_size(mesh)

    def step(batch):
        with torch.no_grad():
            hm = _forward_heatmaps(model, batch["image"], flip_tta)
            metrics = _eval_metrics(hm, batch, group, world)
            preds, maxvals, _ = decode_heatmaps(hm, batch["center"],
                                                batch["scale"])
            return torch.cat([preds, maxvals[..., None]], dim=-1), metrics

    return step
