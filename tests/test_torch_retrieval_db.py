"""The port's retrieval engines (stlpose_tpu_torch/engines/retrieval_db.py)
and the scripts behind them, against the JAX package.

- Extractor: the port's ``ArchDataExtractor(device="cpu")`` and the JAX
  one on HRNET_TINY with the same weights (JAX variables drawn by
  tests/test_torch_hrnet.py::random_variables, carried over by
  models/convert.py and saved as the port experiment's checkpoint; the
  JAX engine is handed them instead of Flax's eager init), on 6 images of
  tests/fixtures.py::make_archdata_dataset: keys, images, characters,
  centres and scales equal, joints' x/y equal, visibility equal. Both run
  the host-warp pipeline; the two networks' heatmaps differ by rounding
  (~1e-6), so every map's top-2 gap is asserted > 1e-4 and every maximum
  clear of ``kpt_thr`` by as much.
- Experimenter: the results JSONs equal to the JAX one's, ``timestamp``
  and ``retrival_time`` aside, on the same kNN artifacts.
- Scripts: aux_map -> 05 -> 06 -> 07 (knn) -> 07_retrieval_test ->
  07_display through ``main(argv)`` on the CPU, the PNGs written.
- No run without a card unless ``device="cpu"``.
"""

import importlib
import json
import os
import pickle

import numpy as np
import pytest
import torch

from stlpose_tpu.engines import retrieval_db as jax_engine
from stlpose_tpu.retrieval import pose_db as jax_pose_db
from stlpose_tpu_torch.config import HRNET_TINY
from stlpose_tpu_torch.engines.retrieval_db import (ArchDataExtractor,
                                                    RetrievalExperimenter)
from stlpose_tpu_torch.models.convert import hrnet_from_jax
from stlpose_tpu_torch.retrieval import pose_db
from stlpose_tpu_torch.train.state import create_train_state
from stlpose_tpu_torch.utils.checkpoint import save_checkpoint
from stlpose_tpu_torch.utils.experiment import (create_experiment,
                                                load_experiment_parameters)
from tests.fixtures import make_archdata_dataset
from tests.test_torch_retrieval_hnsw import jax_hnsw_built_in
import tests.torch_threads  # noqa: F401  (caps torch's threads)

N_IMAGES, KPT_THR, MARGIN = 6, 0.1, 1e-4
CHARACTERS = ("Heracles", "satyr", "maenad")
NARRATIVES = {"myth": ["Heracles"], "dionysian": ["satyr", "maenad"]}


def script(name):
    return importlib.import_module(f"stlpose_tpu_torch.scripts.{name}")


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """The arch_data fixture, tiny HRNet weights as JAX variables, and a
    port experiment holding them as its checkpoint "final"."""
    import jax
    import jax.numpy as jnp
    from stlpose_tpu.config import get_hrnet_config as jax_hrnet_config
    from stlpose_tpu.models.hrnet import PoseHighResolutionNet as JaxHRNet
    from tests.test_torch_hrnet import random_variables

    root = tmp_path_factory.mktemp("retrieval")
    data = str(root / "data")
    make_archdata_dataset(data, n_imgs=N_IMAGES, img_hw=(240, 320))
    model = JaxHRNet(config=jax_hrnet_config("tiny"))
    pv = random_variables(jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 256, 192, 3)), train=False)), 3)
    exp_path = create_experiment("port", {"batch_size": 4},
                                 root=str(root / "experiments"))
    pose = hrnet_from_jax(pv, HRNET_TINY, device="cpu")
    save_checkpoint(create_train_state(pose, load_experiment_parameters(
        exp_path)), exp_path, "final")
    return {"root": root, "data": data, "exp": exp_path, "pv": pv,
            "model": model}


def jax_extract(ws):
    """The JAX extractor's database, its network given the workspace's
    variables (what its ``setup`` builds, less Flax's eager init)."""
    from stlpose_tpu.data.loaders import load_dataset
    from stlpose_tpu.parallel import get_mesh
    from stlpose_tpu.parallel.steps import make_infer_fn
    from stlpose_tpu.train.state import PoseTrainState
    from stlpose_tpu.utils.experiment import create_experiment as jax_exp

    exp_path = jax_exp("jax", {"batch_size": 4},
                       root=str(ws["root"] / "jax_experiments"))
    ex = jax_engine.ArchDataExtractor(exp_path, dataset_name="arch_data",
                                      data_path=ws["data"], num_workers=2,
                                      kpt_thr=KPT_THR)
    ex.mesh = get_mesh()
    _, ex.pipe = load_dataset(ex.exp_data, train=False,
                              data_path=ws["data"], num_workers=2,
                              pad_multiple=ex.mesh.devices.size)
    ex.model = ws["model"]
    ex.state = PoseTrainState(ws["pv"]["params"], ws["pv"]["batch_stats"],
                              None, 0)
    ex.infer = make_infer_fn(ex.model, ex.mesh, flip_tta=True, decode=False)
    return ex.extract_retrieval_dataset()


def port_extractor(ws):
    ex = ArchDataExtractor(ws["exp"], checkpoint="final",
                           dataset_name="arch_data", data_path=ws["data"],
                           num_workers=2, kpt_thr=KPT_THR, device="cpu")
    ex.setup(config_name="tiny")
    return ex


def test_extractor_matches_jax(workspace):
    ex = port_extractor(workspace)
    # the port's heatmaps of the same batches: every peak and every
    # visibility decision clear of the two networks' rounding difference
    for batch in ex.pipe:
        hm = ex.infer(batch["image"])[:batch["n_valid"]]
        top2 = hm.flatten(2).topk(2, dim=-1).values
        assert float((top2[..., 0] - top2[..., 1]).min()) > MARGIN
        assert float((top2[..., 0] - KPT_THR).abs().min()) > MARGIN
    db = ex.extract_retrieval_dataset()
    ref = jax_extract(workspace)
    assert list(db) == list(ref) == [f"img_{i}" for i in range(N_IMAGES)]
    visible = 0
    for key, item in db.items():
        r = ref[key]
        assert item["img"] == r["img"]
        assert item["character_name"] == r["character_name"]
        assert item["character_name"] in CHARACTERS
        for k in ("center", "scale"):
            assert isinstance(item[k], np.ndarray)
            np.testing.assert_array_equal(item[k], r[k])
        assert isinstance(item["joints"], np.ndarray)
        assert item["joints"].shape == (17, 3)
        assert item["joints"].dtype == np.float32
        np.testing.assert_array_equal(item["joints"][:, :2],
                                      np.asarray(r["joints"])[:, :2])
        np.testing.assert_array_equal(item["joints"][:, 2],
                                      np.asarray(r["joints"])[:, 2])
        assert (0 <= item["joints"][:, 0]).all() and \
            (item["joints"][:, 0] <= 191).all()
        assert (0 <= item["joints"][:, 1]).all() and \
            (item["joints"][:, 1] <= 255).all()
        visible += int(item["joints"][:, 2].sum())
    assert 0 < visible < 17 * N_IMAGES     # the flag is not constant
    # the pickled database holds numpy arrays, so the JAX 06 reads it
    path = ex.save_retrieval_db(root=str(workspace["root"] / "db"))
    with open(path, "rb") as f:
        loaded = pickle.load(f)
    joints = np.array([loaded[k]["joints"] for k in loaded])
    np.testing.assert_array_equal(
        pose_db.process_data(joints, "full_body"),
        jax_pose_db.process_data(joints, "full_body"))


def clustered_db(seed=0, per=12):
    """3 characters x ``per`` poses clustered around a centre each, with
    occluded keypoints."""
    rng = np.random.RandomState(seed)
    centers = rng.rand(3, 17, 2) * 150 + 20
    db = {}
    for i in range(3 * per):
        c = i % 3
        joints = np.concatenate([centers[c] + rng.randn(17, 2) * 12,
                                 np.ones((17, 1))], axis=1)
        joints[rng.rand(17) < 0.1, :2] = 0
        db[f"img_{i}"] = {"img": f"i{i}.jpg", "joints": joints,
                          "center": np.zeros(2), "scale": np.ones(2),
                          "character_name": CHARACTERS[c]}
    return db


def write_maps(dict_path):
    os.makedirs(dict_path, exist_ok=True)
    c2n = {c: n for n, cs in NARRATIVES.items() for c in cs}
    with open(os.path.join(dict_path, "char_narrative_map.json"), "w") as f:
        json.dump(c2n, f)
    with open(os.path.join(dict_path, "narrative_char_map.json"), "w") as f:
        json.dump(NARRATIVES, f)


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    with jax_hnsw_built_in(tmp_path_factory.mktemp("jax_native")):
        yield


@pytest.mark.parametrize("method,penalization", [
    ("knn", "none"), ("euclidean_distance", "none"), ("oks_score", "mean"),
    ("confidence_score", "zero_coord")])
def test_experimenter_matches_jax(method, penalization, jax_native,
                                  tmp_path):
    db = clustered_db()
    feats = pose_db.process_data(np.array([db[k]["joints"] for k in db]),
                                 "full_body", True)
    name = "database_arch_eval_metric_euclidean_distance_norm_True.pkl"
    knn = str(tmp_path / "knn")
    pose_db.save_knn_structure(pose_db.create_graph(feats), feats, db, name,
                               root=knn)
    write_maps(str(tmp_path / "dicts"))
    out = {}
    for tag, cls in (("port", RetrievalExperimenter),
                     ("jax", jax_engine.RetrievalExperimenter)):
        exp = cls(str(tmp_path / tag), "data_" + name,
                  retrieval_method=method, penalization=penalization,
                  knn_root=knn, dict_path=str(tmp_path / "dicts"))
        exp.setup()
        exp.retrieval_experiment()
        for level in ("character", "narrative"):
            exp.process_retrieval_results(level)
        files = sorted(os.listdir(tmp_path / tag))
        out[tag] = (files, [json.load(open(tmp_path / tag / f))
                            for f in files])
    assert out["port"][0] == out["jax"][0] and len(out["port"][0]) == 2
    for got, ref in zip(out["port"][1], out["jax"][1]):
        for blob in (got, ref):
            del blob["metadata"]["timestamp"], blob["metadata"]["retrival_time"]
        assert got == ref
    general = out["port"][1][0]["results"]["general"]
    assert all(0.0 <= v <= 1.0 for v in general.values())


def test_scripts_chain_on_the_cpu(workspace, tmp_path, monkeypatch, capsys):
    """aux_map -> 05 -> 06 -> 07 (knn) -> 07_retrieval_test -> 07_display
    through each script's main(argv); 05 under ``STLPOSE_PROFILE``."""
    from stlpose_tpu_torch.config import CONFIG
    monkeypatch.setitem(CONFIG["paths"], "database_path",
                        str(tmp_path / "databases"))
    monkeypatch.setenv("STLPOSE_MODEL_CONFIG", "tiny")
    monkeypatch.setenv("STLPOSE_PRETRAINED", "")
    narratives = tmp_path / "narratives.json"
    narratives.write_text(json.dumps(NARRATIVES))
    dicts, knn = str(tmp_path / "dicts"), str(tmp_path / "knn")
    c2n, _ = script("aux_map_characters_to_narratives").main(
        ["--narratives_json", str(narratives), "--dict_path", dicts])
    assert c2n == {"Heracles": "myth", "satyr": "dionysian",
                   "maenad": "dionysian"}
    profile = tmp_path / "profile"
    monkeypatch.setenv("STLPOSE_PROFILE", str(profile))
    db_path = script("05_create_archdata_retrieval_db").main(
        ["-d", workspace["exp"], "--checkpoint", "final", "--data_path",
         workspace["data"], "--device", "cpu"])
    spans, = [f for f in os.listdir(profile) if f.startswith("spans_")]
    with open(profile / spans) as f:
        names = {s["name"] for s in json.load(f)["spans"]}
    assert {"extract.batch", "extract.peaks", "extract.fetch",
            "extract.add_batch", "pipeline.batch"} <= names
    assert os.path.basename(db_path) == (
        f"database_arch_data_{os.path.basename(workspace['exp'])}_eval.pkl")
    name = script("06_fit_knn_tree").main(
        ["--database_file", os.path.basename(db_path), "--knn_path", knn])
    results = script("07_retrieval_experiments").main(
        ["-d", str(tmp_path / "results"), "--database_file", "data_" + name,
         "--knn_path", knn, "--dict_path", dicts])
    for level, res in results.items():
        general = res["results"]["general"]
        assert res["metadata"]["database size"] == N_IMAGES
        assert all(v == -1.0 or 0.0 <= v <= 1.0 for v in general.values())
    assert len(os.listdir(tmp_path / "results")) == 2
    pngs = script("07_retrieval_test").main(
        ["--database_file", "data_" + name, "--knn_path", knn,
         "--num_queries", "2", "--num_retrievals", "3", "--output_dir",
         str(tmp_path / "test_plots")])
    drawn = script("07_display_database_skeletons").main(
        ["--database_file", db_path, "--output_dir",
         str(tmp_path / "skeletons"), "--limit", "3"])
    capsys.readouterr()
    assert len(pngs) == 2 and len(drawn) == 3
    assert all(os.path.getsize(p) > 0 for p in pngs + drawn)


def test_extractor_defaults_to_the_card(workspace, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ArchDataExtractor(workspace["exp"])
    ArchDataExtractor(workspace["exp"], device="cpu")
