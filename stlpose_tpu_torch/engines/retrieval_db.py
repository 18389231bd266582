"""Retrieval-database extraction and retrieval-experiment engines.

Port of ``stlpose_tpu/engines/retrieval_db.py``, the engines behind
``05_create_archdata_retrieval_db.py`` and ``07_retrieval_experiments.py``:

- ``ArchDataExtractor``: the experiment's eval split in batches, one
  flip-TTA HRNet forward of each (``parallel/steps.py::make_infer_fn``),
  the heatmap peaks on K1 (``ops/decode.py::heatmap_argmax``) on the
  device, then only the coordinates and maxima fetched; on the host,
  coordinates scaled to the 256x192 crop frame and a ``maxval >=
  kpt_thr`` visibility flag; pickled as ``database_{ds}_{exp}_eval.pkl``.
  The database holds numpy arrays, so either package's 06 reads the
  other's 05 output. The compute dtype is the constructor's ``dtype``
  (the reference reads ``STLPOSE_DTYPE``).
- ``RetrievalExperimenter``: query-all retrieval scoring at character and
  narrative level with grouped result JSONs (host numpy, as in the JAX
  package).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from stlpose_tpu_torch import resolve_device
from stlpose_tpu_torch.config import CONFIG, get_hrnet_config
from stlpose_tpu_torch.data.loaders import load_dataset
from stlpose_tpu_torch.models.hrnet import PoseHighResolutionNet
from stlpose_tpu_torch.ops.decode import heatmap_argmax
from stlpose_tpu_torch.parallel.steps import make_infer_fn
from stlpose_tpu_torch.retrieval import (get_neighbors_idxs, load_knn,
                                         process_pose_vector, save_database,
                                         score_retrievals)
from stlpose_tpu_torch.train.state import create_train_state
from stlpose_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                load_pretrained_variables)
from stlpose_tpu_torch.utils.experiment import (load_experiment_parameters,
                                                timestamp)
from stlpose_tpu_torch.utils.logger import print_

RES_KEYS = ("p@1", "p@5", "p@10", "p@rel", "mAP",
            "r@1", "r@5", "r@10", "r@rel", "mAR")
CROP_W, CROP_H = 192, 256      # the crop frame the database's joints live in


class ArchDataExtractor:
    """Engine behind 05_create_archdata_retrieval_db.py, on ``device``
    ("cuda" unless the caller asks for the CPU) in compute ``dtype``."""

    def __init__(self, exp_path: str, checkpoint=None, dataset_name=None,
                 data_path=None, kpt_thr: float = 0.1, num_workers=None,
                 dtype=torch.float32, device="cuda"):
        self.device = resolve_device(device)
        self.exp_path = exp_path
        self.exp_data = load_experiment_parameters(exp_path)
        if dataset_name:
            self.exp_data["dataset"]["dataset_name"] = dataset_name
        self.checkpoint = checkpoint
        self.data_path = data_path
        self.kpt_thr = kpt_thr
        self.num_workers = num_workers
        self.dtype = dtype
        self.retrieval_db = {}

    def setup(self, config_name: str = "w32_256x192", pretrained=None):
        _, self.pipe = load_dataset(
            self.exp_data, train=False, data_path=self.data_path,
            num_workers=self.num_workers, device=self.device)
        # random init from the experiment seed, without touching the
        # caller's generator
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(CONFIG["random_seed"])
            self.model = PoseHighResolutionNet(get_hrnet_config(config_name),
                                               self.device, self.dtype)
        load_pretrained_variables(self.model, pretrained)
        self.state = create_train_state(self.model, self.exp_data)
        if self.checkpoint is not None:
            self.state, _ = load_checkpoint(self.state, self.exp_path,
                                            self.checkpoint, only_model=True)
        # flip-TTA heatmaps, no image-space decode: the database's poses
        # live in crop coordinates
        self.infer = make_infer_fn(self.model, flip_tta=True, decode=False)

    def batch_peaks(self, images, n: int):
        """The device work of one batch: flip-TTA heatmaps, then K1's
        peaks of the ``n`` real entries as one (n, J, 3) [x, y, maxval]
        tensor, and the heatmaps' (H, W)."""
        hm = self.infer(images)
        coords, maxvals = heatmap_argmax(hm[:n])
        return torch.cat([coords, maxvals[..., None]], dim=-1), hm.shape[2:]

    def add_batch(self, peaks, hw, batch, records):
        """Host side of one batch: ``peaks`` (numpy, from
        :meth:`batch_peaks`) scaled to the 256x192 crop frame (the
        reference decodes from bilinearly x4-upsampled maps,
        align_corners=True), the visibility flag, one database entry
        each."""
        coords = peaks[..., :2].copy()
        maxvals = peaks[..., 2]
        Hh, Hw = hw
        coords[..., 0] *= (CROP_W - 1.0) / (Hw - 1)
        coords[..., 1] *= (CROP_H - 1.0) / (Hh - 1)
        visible = (maxvals >= self.kpt_thr).astype(np.float32)
        for b in range(len(peaks)):
            i = len(self.retrieval_db)
            rec = records[min(i, len(records) - 1)]
            joints = np.concatenate([coords[b], visible[b][:, None]],
                                    axis=1).astype(np.float32)
            self.retrieval_db[f"img_{i}"] = {
                "img": os.path.basename(rec.image),
                "joints": joints,
                "center": batch["center"][b],
                "scale": batch["scale"][b],
                "character_name": rec.character_name,
            }

    def extract_retrieval_dataset(self, records=None):
        """Build {img_N: {img, joints (17, 3), center, scale,
        character_name}} over the eval split."""
        records = records if records is not None else self.pipe.records
        for batch in self.pipe:
            peaks, hw = self.batch_peaks(batch["image"], batch["n_valid"])
            self.add_batch(peaks.cpu().numpy(), hw, batch, records)
        return self.retrieval_db

    def save_retrieval_db(self, root=None) -> str:
        name = (f"{self.exp_data['dataset']['dataset_name']}_"
                f"{os.path.basename(self.exp_path)}")
        return save_database(self.retrieval_db, name, "eval", root)


def load_character_narrative_maps(dict_path: str | None = None):
    """char->narrative and narrative->chars maps
    (reference: lib/utils.py:421-445)."""
    dict_path = dict_path or CONFIG["paths"]["dict_path"]
    char_path = os.path.join(dict_path, "char_narrative_map.json")
    narr_path = os.path.join(dict_path, "narrative_char_map.json")
    if not (os.path.exists(char_path) and os.path.exists(narr_path)):
        raise FileNotFoundError(
            "Character/narrative mapping dicts missing; run "
            "stlpose_tpu_torch/scripts/aux_map_characters_to_narratives.py "
            "first")
    with open(char_path) as f:
        char_to_narr = json.load(f)
    with open(narr_path) as f:
        narr_to_char = json.load(f)
    return char_to_narr, narr_to_char


class RetrievalExperimenter:
    """Engine behind 07_retrieval_experiments.py."""

    def __init__(self, exp_directory: str, database_file: str,
                 retrieval_method: str = "knn", approach: str = "full_body",
                 penalization: str = "none", normalize: bool = True,
                 num_retrievals: int = -1, knn_root=None, dict_path=None):
        self.exp_directory = exp_directory
        self.database_file = database_file
        self.retrieval_method = retrieval_method
        self.approach = approach
        self.penalization = penalization
        self.normalize = normalize
        self.num_retrievals = num_retrievals
        self.knn_root = knn_root
        self.dict_path = dict_path

    def setup(self):
        self.knn, self.database, self.features = load_knn(
            self.database_file, root=self.knn_root)
        self.key_list = list(self.database.keys())
        self.n_entries = len(self.key_list)
        if self.num_retrievals < 0:
            self.num_retrievals = self.n_entries
        self.char_to_narr, self.narr_to_char = \
            load_character_narrative_maps(self.dict_path)

    def retrieval_experiment(self):
        character_results, narrative_results = [], []
        t0 = time.time()
        for key in self.key_list:
            query = self.database[key]
            joints = np.asarray(query["joints"])
            label_char = query["character_name"]
            label_narr = self.char_to_narr.get(label_char, label_char)
            vec = process_pose_vector(joints, self.approach, self.normalize)
            idx, _ = get_neighbors_idxs(
                vec, num_retrievals=self.num_retrievals,
                approach=self.approach,
                retrieval_method=self.retrieval_method,
                penalization=self.penalization,
                knn=self.knn, database=self.features)
            retrieved = [self.database[self.key_list[int(j)]]
                         for j in idx if 0 <= int(j) < self.n_entries]
            chars = [r["character_name"] for r in retrieved]
            narrs = [self.char_to_narr.get(c, c) for c in chars]
            character_results.append(score_retrievals(label_char, chars))
            narrative_results.append(score_retrievals(label_narr, narrs))
        self.elapsed_time = time.time() - t0
        self.character_results = character_results
        self.narrative_results = narrative_results

    def process_retrieval_results(self, type: str = "character",
                                  save: bool = True):
        """Group per-label and overall averages, save results JSON
        (07_retrieval_experiments.py:114-180)."""
        assert type in ("character", "narrative")
        scores = (self.character_results if type == "character"
                  else self.narrative_results)
        results = {"general": {k: [] for k in RES_KEYS}}
        for score in scores:
            label = score["label"]
            results.setdefault(label, {k: [] for k in RES_KEYS})
            for k in RES_KEYS:
                results[label][k].append(score[k])
                if score[k] >= 0:
                    results["general"][k].append(score[k])
        for label in results:
            for k in RES_KEYS:
                vals = results[label][k]
                results[label][k] = float(np.mean(vals)) if vals else -1.0
            print_(f"Retrieval results for {type}: '{label}'")

        dataset_name = self.database_file.split("database_")[-1] \
            .split("_eval")[0]
        savedict = {
            "results": results,
            "metadata": {
                "timestamp": timestamp(),
                "dataset_name": dataset_name,
                "retrival_time": self.elapsed_time,
                "database size": self.n_entries,
                "retrieval_level": type,
                "retrieval_method": self.retrieval_method,
                "pose approach": self.approach,
                "missing kpt penalization": self.penalization,
                "normalized poses": self.normalize,
            },
        }
        if save:
            fname = (f"retrieval_results_type_{type}_method_"
                     f"{self.retrieval_method}_approach_{self.approach}_"
                     f"penalization_{self.penalization}_normalized_"
                     f"{self.normalize}.json")
            os.makedirs(self.exp_directory, exist_ok=True)
            with open(os.path.join(self.exp_directory, fname), "w") as f:
                json.dump(savedict, f)
        return savedict
