"""Serving export of the port (stlpose_tpu_torch/serving/export.py): pose
artifacts written by ``torch.export``, reloaded, and held against the
port's live call and the JAX package's live serving function, on
HRNET_TINY with weights from models/convert.py (the round trips of
tests/test_serving_export.py: batch polymorphism, int8, self-contained,
flip-TTA), and script 08 from 01's experiment to a loaded artifact. The
detector artifacts are in tests/test_torch_serving_export_detectors.py,
the two-stage ones in tests/test_torch_serving_export_two_stage.py.

Bounds. Each reloaded artifact equals the port's live eager call at 0.0.
The live call is held to the JAX package's at the bounds the port's tests
already use for that model and flavor: the bf16 HRNet's heatmaps by
tests/test_torch_bf16.py's bound (within 2E of the JAX bf16 program and
between 0.4E and 2E of the JAX f32 one); the int8 flavors' heatmaps,
calibrated and quantized on each side from the same live weights and
crops, within tests/test_torch_int8_models.py's end-to-end 5e-2 of their
largest magnitude; the decode of the live call's own heatmaps by the JAX
decode as tests/test_torch_affine_decode.py holds it (peaks and maxima
exact, keypoints 1e-4 px)."""

import importlib
import json
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stlpose_tpu.models import create_hrnet as jax_create_hrnet
from stlpose_tpu.models import fold_batchnorms as jax_fold
from stlpose_tpu.models.quantize import calibrate_hrnet as jax_calibrate
from stlpose_tpu.models.quantize import quantize_hrnet as jax_quantize
from stlpose_tpu.ops.decode import decode_heatmaps_nhwc as jax_decode_nhwc
from stlpose_tpu.serving.export import \
    _INT8_ACCURACY_CAVEAT as JAX_CAVEAT
from stlpose_tpu.serving.export import _build_serving_fn
from stlpose_tpu_torch.config import HRNET_TINY
from stlpose_tpu_torch.models.convert import hrnet_from_jax
from stlpose_tpu_torch.serving import (export_detector_server,
                                       export_pose_server,
                                       export_two_stage_server,
                                       load_pose_server,
                                       load_two_stage_server)
from stlpose_tpu_torch.serving.export import PoseServer, pose_server_model
from stlpose_tpu_torch.utils.experiment import create_experiment
from tests.test_torch_bf16 import _assert_bf16_bound
from tests.test_torch_hrnet import jax_hrnet
from tests.torch_serving import (assert_graph_names_its_kernels,
                                 assert_same)
import tests.torch_threads  # noqa: F401  (caps torch's threads)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIG, HW = "tiny", (64, 64)
E2E_HM_REL = 5e-2
_ARTIFACTS = {}


def _crops(seed, n):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n,) + HW + (3,), dtype=np.uint8),
            rng.uniform(50, 200, (n, 2)).astype(np.float32),
            rng.uniform(0.5, 2.0, (n, 2)).astype(np.float32))


def _calib():
    return np.random.RandomState(3).randint(0, 256, (4,) + HW + (3,),
                                            dtype=np.uint8)


@pytest.fixture(scope="module")
def pose_weights():
    """The JAX HRNET_TINY's live variables and the port's live HRNet
    holding them."""
    _, v = jax_hrnet(CONFIG, 0)
    return v, hrnet_from_jax(v, HRNET_TINY, device="cpu")


def artifact(kind, tmp_path_factory, request):
    """(directory, loaded callable, manifest) of the pose artifact of
    ``kind`` ("pose", "pose_flip", "pose_int8", "pose_int8u"), exported
    and loaded once per module."""
    if kind not in _ARTIFACTS:
        out = str(tmp_path_factory.mktemp(kind))
        _, port = request.getfixturevalue("pose_weights")
        quant = kind.split("_")[1] if kind.count("_") else "none"
        export_pose_server(port, out, config_name=CONFIG, input_hw=HW,
                           device="cpu", flip_tta=quant == "flip",
                           quant="none" if quant == "flip" else quant,
                           calib_crops=_calib())
        _ARTIFACTS[kind] = (out, *load_pose_server(out, device="cpu"))
    return _ARTIFACTS[kind]


def _numpy(out):
    return {k: v.numpy() for k, v in out.items()}


def _assert_decode_matches_jax(hm, centers, scales, got):
    """The live call's keypoints, maxima and refined peaks are the JAX
    decode of the live call's own heatmaps."""
    p, m, c = (np.asarray(a) for a in jax_decode_nhwc(
        jnp.asarray(hm), centers, scales))
    np.testing.assert_array_equal(got["heatmaps"], c)
    np.testing.assert_array_equal(got["scores"], m)
    np.testing.assert_allclose(got["keypoints"], p, rtol=0, atol=1e-4)


def _jax_pose_heatmaps(variables, crops, dtype, quant="none",
                       flip_tta=False):
    """Heatmaps of the JAX serving function's model (``_build_serving_fn``)
    on uint8 crops, normalised and flipped as it does, jitted once."""
    _, model = _build_serving_fn(CONFIG, dtype, quant=quant)
    mean = jnp.asarray([0.485, 0.456, 0.406], jnp.float32) * 255.0
    std = jnp.asarray([0.229, 0.224, 0.225], jnp.float32) * 255.0

    def heatmaps(v, crops_u8):
        x = (crops_u8.astype(jnp.float32) - mean) / std
        if not flip_tta:
            return model.apply(v, x, train=False)
        from stlpose_tpu.ops.flip import average_flip_tta_nhwc
        n = x.shape[0]
        out = model.apply(v, jnp.concatenate([x, x[:, :, ::-1, :]]),
                          train=False)
        return average_flip_tta_nhwc(out[:n], out[n:])

    return np.asarray(jax.jit(heatmaps)(variables, jnp.asarray(crops))
                      ).astype(np.float32)


@pytest.mark.parametrize("flip_tta", [False, True])
def test_pose_artifact_serves_any_batch(pose_weights, tmp_path_factory,
                                        request, flip_tta):
    """The bf16 folded pose artifact (symbolic batch) at batches 2 and 5,
    and its flip-TTA flavor: equal to the live call; the live heatmaps
    within the bf16 bound of the JAX serving function's, its decode the
    JAX decode's; the flip-TTA program is not the plain one."""
    v, port = pose_weights
    _, serve, mf = artifact("pose_flip" if flip_tta else "pose",
                            tmp_path_factory, request)
    assert mf["bn_folded"] and mf["config"] == CONFIG and \
        mf["flip_tta"] == flip_tta and mf["device"] == "cpu"
    live = PoseServer(pose_server_model(port, CONFIG, "cpu"), flip_tta)
    for n in (2, 5):
        crops, centers, scales = (torch.from_numpy(a) for a in
                                  _crops(n, n))
        got = serve(crops, centers, scales)
        with torch.inference_mode():
            ref = live(crops, centers, scales)
            hm = live.heatmaps(crops)
        assert_same(got, ref)
    assert got["keypoints"].shape == (5, 17, 2)
    _assert_decode_matches_jax(hm.numpy(), centers.numpy(),
                               scales.numpy(), _numpy(got))
    folded = jax_fold(v)
    _assert_bf16_bound(
        hm.numpy(),
        _jax_pose_heatmaps(folded, crops.numpy(), jnp.bfloat16,
                           flip_tta=flip_tta),
        _jax_pose_heatmaps(folded, crops.numpy(), jnp.float32,
                           flip_tta=flip_tta))
    if flip_tta:
        plain = artifact("pose", tmp_path_factory, request)[1]
        assert not torch.equal(plain(crops, centers, scales)["scores"],
                               got["scores"])


@pytest.mark.parametrize("quant", ["int8", "int8u"])
def test_pose_int8_artifacts(pose_weights, tmp_path, tmp_path_factory,
                             request, quant):
    """The w8a8 flavors: the caveat warned and in the manifest (the JAX
    package's text); int8 refuses no-fold, flip-TTA and missing crops;
    the artifact equals the live call; the live heatmaps, calibrated and
    quantized by the port, within the end-to-end bound of the JAX serving
    function's on the JAX package's own calibration of the same crops."""
    v, port = pose_weights
    calib = _calib()
    for bad in (dict(fold=False), dict(flip_tta=True), dict(calib_crops=None)):
        kw = {"calib_crops": calib, **bad}
        with pytest.raises(ValueError, match="int8 export"):
            export_pose_server(port, str(tmp_path / "bad"), CONFIG, HW,
                               device="cpu", quant=quant, **kw)
    with pytest.warns(UserWarning, match=re.escape(JAX_CAVEAT[quant])):
        _, serve, mf = artifact(f"pose_{quant}", tmp_path_factory, request)
    assert mf["quant"] == quant and mf["compute_dtype"].startswith("int8")
    assert mf["accuracy_caveat"] == JAX_CAVEAT[quant]
    live = PoseServer(pose_server_model(port, CONFIG, "cpu", True, quant,
                                        calib))
    crops, centers, scales = (torch.from_numpy(a) for a in _crops(7, 3))
    got = serve(crops, centers, scales)
    with torch.inference_mode():
        ref = live(crops, centers, scales)
        hm = live.heatmaps(crops).numpy()
    assert_same(got, ref)
    _assert_decode_matches_jax(hm, centers.numpy(), scales.numpy(),
                               _numpy(got))

    folded = jax_fold(v)
    mean = jnp.asarray([0.485, 0.456, 0.406], jnp.float32) * 255.0
    std = jnp.asarray([0.229, 0.224, 0.225], jnp.float32) * 255.0
    xc = (jnp.asarray(calib).astype(jnp.float32) - mean) / std
    stats = jax_calibrate(jax_create_hrnet(CONFIG, folded=True,
                                           quant="calib"), folded, [xc])
    qvars = jax_quantize(folded, stats, act_scheme="signed"
                         if quant == "int8" else "unsigned")
    want = _jax_pose_heatmaps(qvars, crops.numpy(), jnp.bfloat16, quant)
    assert np.abs(hm - want).max() <= E2E_HM_REL * np.abs(want).max()


def test_artifact_is_self_contained(pose_weights, tmp_path_factory, request,
                                    tmp_path):
    """A byte copy of the pose artifact serves in a fresh process that
    imports only ``stlpose_tpu_torch.serving`` (and torch): the same
    outputs as the live call, and no model module of the port and no JAX
    in that process."""
    src = artifact("pose", tmp_path_factory, request)[0]
    copy = tmp_path / "copy"
    copy.mkdir()
    for name in ("model.pt2", "manifest.json"):
        (copy / name).write_bytes(open(f"{src}/{name}", "rb").read())
    assert (copy / "model.pt2").stat().st_size > 10000
    code = (
        "import json, sys, torch\n"
        "from stlpose_tpu_torch.serving import load_pose_server\n"
        "serve, m = load_pose_server(sys.argv[1], device='cpu')\n"
        "a = [torch.tensor(json.loads(x)) for x in sys.argv[2:]]\n"
        "out = serve(a[0].to(torch.uint8), a[1], a[2])\n"
        "mods = [n for n in sys.modules if n.startswith("
        "'stlpose_tpu_torch.models') or n.split('.')[0] in "
        "('jax', 'flax', 'stlpose_tpu')]\n"
        "print(json.dumps({'modules': mods, 'out': {k: v.tolist() for k, v "
        "in out.items()}}))\n")
    crops, centers, scales = _crops(11, 2)
    res = subprocess.run(
        [sys.executable, "-c", code, str(copy),
         *(json.dumps(a.tolist()) for a in (crops, centers, scales))],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["modules"] == []
    live = PoseServer(pose_server_model(pose_weights[1], CONFIG, "cpu"))
    with torch.inference_mode():
        ref = live(*(torch.from_numpy(a) for a in (crops, centers, scales)))
    for k, v in ref.items():
        np.testing.assert_array_equal(np.asarray(got["out"][k], np.float32),
                                      v.numpy(), err_msg=k)


@pytest.mark.parametrize("kind, kernels", [
    ("pose", ["heatmap_peaks"]),
    ("pose_int8u", ["heatmap_peaks", "int8_conv", "quantize_activations"])])
def test_graph_names_the_kernels_of_its_path(kind, kernels, tmp_path_factory,
                                             request):
    """Each artifact's graph calls the ``stlpose`` operator of every kernel
    its path reaches and no other, the manifest names the same, no plain
    version is inlined, and the program moves whole to another device."""
    _, serve, mf = artifact(kind, tmp_path_factory, request)
    assert_graph_names_its_kernels(serve.program, mf, kernels)


def test_entry_points_default_to_the_card(monkeypatch, pose_weights,
                                          tmp_path_factory, request,
                                          tmp_path):
    """Every export and load function runs on "cuda" unless told
    otherwise, and raises where there is no GPU."""
    out = artifact("pose", tmp_path_factory, request)[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port = pose_weights[1]
    for call in (
            lambda: export_pose_server(port, str(tmp_path), CONFIG, HW),
            lambda: export_detector_server({}, str(tmp_path)),
            lambda: export_two_stage_server({}, port, str(tmp_path)),
            lambda: load_pose_server(out),
            lambda: load_two_stage_server(out)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not (tmp_path / "manifest.json").exists()


def test_script_08_exports_int8u_pose_from_an_experiment(tmp_path,
                                                         monkeypatch):
    """01 -> 08 ``--pipeline pose --quant int8u --calib_images <.npy>
    --device cpu`` -> ``load_pose_server``: the artifact equals the live
    call on the weights the script restores (the experiment's seed, no
    ``.pth``), with the caveat warned and K6's operators in its graph."""
    monkeypatch.setenv("STLPOSE_MODEL_CONFIG", CONFIG)
    monkeypatch.setenv("STLPOSE_PRETRAINED", "")
    exp = create_experiment("serve", root=str(tmp_path))
    calib = np.random.RandomState(5).randint(0, 256, (3, 256, 192, 3),
                                             dtype=np.uint8)
    np.save(tmp_path / "calib.npy", calib)
    script = importlib.import_module(
        "stlpose_tpu_torch.scripts.08_export_serving")
    with pytest.warns(UserWarning, match=re.escape(JAX_CAVEAT["int8u"])):
        out = script.main(["-d", exp, "--quant", "--calib_images",
                           str(tmp_path / "calib.npy"), "--device", "cpu"])
    assert out == os.path.join(exp, "serving_export")
    serve, mf = load_pose_server(out, device="cpu")
    assert mf["quant"] == "int8u" and mf["kernels"] == [
        "heatmap_peaks", "int8_conv", "quantize_activations"]
    weights = script.pose_weights(exp, None, CONFIG, None, "cpu")
    live = PoseServer(pose_server_model(weights, CONFIG, "cpu", True,
                                        "int8u", calib))
    crops = torch.from_numpy(calib[:2])
    centers = torch.full((2, 2), 96.0)
    scales = torch.full((2, 2), 1.5)
    with torch.inference_mode():
        assert_same(serve(crops, centers, scales),
                      live(crops, centers, scales))

