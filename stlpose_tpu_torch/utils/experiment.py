"""Experiment management: directory layout, parameter JSON, training and
evaluation logs.

Port of ``stlpose_tpu/utils/experiment.py``, the same experiment-directory
contract: ``<root>/<dir>/experiment_<timestamp>/{models,plots}`` with
``experiment_parameters.json``, ``training_logs.json``,
``detector_logs.json``, per-checkpoint evaluation-stats JSONs and the
submission file. matplotlib is imported inside ``_plot_landscape`` only.
"""

from __future__ import annotations

import datetime
import json
import os

from stlpose_tpu_torch.config import CONFIG, default_experiment_args

STATS_NAMES = ('AP', 'Ap .5', 'AP .75', 'AP (M)', 'AP (L)', 'AR', 'AR .5',
               'AR .75', 'AR (M)', 'AR (L)')


def timestamp() -> str:
    return datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")


def create_directory(path: str, name: str | None = None) -> str:
    if name is not None:
        path = os.path.join(path, name)
    os.makedirs(path, exist_ok=True)
    return path


def create_experiment(exp_directory: str, overrides: dict | None = None,
                      root: str | None = None) -> str:
    """Create an experiment dir with models/, plots/, tboard_logs/ and the
    parameters JSON (defaults merged with non-None overrides).

    Args:
      exp_directory: name under the experiments root.
      overrides: {group: {key: value}} or flat {key: value} CLI overrides;
        None values are ignored (reference merge rule, lib/utils.py:46-71).
    Returns the experiment path.
    """
    root = root or CONFIG["paths"]["experiments_path"]
    exp_path = os.path.join(root, exp_directory,
                            f"experiment_{timestamp()}")
    create_directory(exp_path)
    create_directory(exp_path, "models")
    create_directory(exp_path, "plots")

    exp_data = {
        "exp_created": timestamp(),
        "last_modified": timestamp(),
        "random_seed": CONFIG["random_seed"],
        "num_workers": CONFIG["num_workers"],
    }
    exp_data.update(default_experiment_args())
    if overrides:
        flat = {}
        for k, v in overrides.items():
            # only explode GROUP-shaped dicts ({"training": {...}});
            # dict-VALUED parameters (e.g. dataset.inline_style) pass
            # through whole
            if isinstance(v, dict) and k in ("dataset", "model",
                                             "training", "evaluation"):
                for kk, vv in v.items():
                    flat[kk] = vv
            else:
                flat[k] = v
        for group in ("dataset", "model", "training", "evaluation"):
            for key in exp_data[group]:
                if flat.get(key) is not None:
                    exp_data[group][key] = flat[key]

    with open(os.path.join(exp_path, "experiment_parameters.json"), "w") as f:
        json.dump(exp_data, f, indent=2)
    return exp_path


def load_experiment_parameters(exp_path: str) -> dict:
    with open(os.path.join(exp_path, "experiment_parameters.json")) as f:
        return json.load(f)


def save_experiment_parameters(exp_path: str, exp_data: dict):
    exp_data["last_modified"] = timestamp()
    with open(os.path.join(exp_path, "experiment_parameters.json"), "w") as f:
        json.dump(exp_data, f, indent=2)


# ------------------------------------------------------------- train logs
def create_train_logs(exp_path: str) -> dict:
    """training_logs.json layout as in the reference (lib/utils.py:127-155)."""
    logs = {
        "last_modified": timestamp(),
        "iterations": 0,
        "loss": {"training": [], "validation": []},
        "accuracy": {"training": [], "validation": []},
    }
    _save_json(os.path.join(exp_path, "training_logs.json"), logs)
    return logs


def load_train_logs(exp_path: str) -> dict:
    with open(os.path.join(exp_path, "training_logs.json")) as f:
        return json.load(f)


def update_train_logs(exp_path: str, logs: dict, iterations: int,
                      train_loss: float, valid_loss: float,
                      train_acc: float, valid_acc: float,
                      make_plots: bool = True) -> dict:
    logs["last_modified"] = timestamp()
    logs["iterations"] = iterations
    logs["loss"]["training"].append(train_loss)
    logs["loss"]["validation"].append(valid_loss)
    logs["accuracy"]["training"].append(train_acc)
    logs["accuracy"]["validation"].append(valid_acc)
    _save_json(os.path.join(exp_path, "training_logs.json"), logs)
    if make_plots:
        _plot_landscape(exp_path, logs)
    return logs


def _plot_landscape(exp_path: str, logs: dict):
    """Loss/accuracy landscape PNGs regenerated each epoch
    (reference: lib/utils.py:211-238)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    plots = create_directory(exp_path, "plots")
    for key in ("loss", "accuracy"):
        fig, ax = plt.subplots(1, 1, figsize=(6, 4))
        ax.plot(logs[key]["training"], label="training")
        ax.plot(logs[key]["validation"], label="validation")
        ax.set_xlabel("epoch")
        ax.set_ylabel(key)
        ax.legend()
        fig.tight_layout()
        fig.savefig(os.path.join(plots, f"{key}_landscape.png"))
        plt.close(fig)


# ---------------------------------------------------------- detector logs
def create_detector_logs(exp_path: str) -> dict:
    logs = {"last_modified": timestamp(), "train_loss": [], "valid_ap": []}
    _save_json(os.path.join(exp_path, "detector_logs.json"), logs)
    return logs


def load_detector_logs(exp_path: str) -> dict:
    with open(os.path.join(exp_path, "detector_logs.json")) as f:
        return json.load(f)


def update_detector_logs(exp_path: str, logs: dict, train_loss: float,
                         valid_ap: float) -> dict:
    logs["last_modified"] = timestamp()
    logs["train_loss"].append(train_loss)
    logs["valid_ap"].append(valid_ap)
    _save_json(os.path.join(exp_path, "detector_logs.json"), logs)
    return logs


# -------------------------------------------------------------- eval stats
def save_evaluation_stats(exp_path: str, stats, detector: bool = False,
                          dataset_name: str | None = None,
                          checkpoint: str | None = None,
                          alpha=None, styles=None):
    """Per-checkpoint COCO stats JSON, keyed layout as the reference
    (lib/utils.py:305-349)."""
    dataset_f = "" if dataset_name is None else f"_{dataset_name}"
    prefix = "detector_evaluation_stats" if detector else "evaluation_stats"
    path = os.path.join(
        exp_path, f"{prefix}{dataset_f}_styles_{styles}_alpha_{alpha}.json")
    stats_dict = {}
    if os.path.exists(path):
        with open(path) as f:
            stats_dict = json.load(f)
    stats_dict[str(checkpoint)] = {
        name: float(stats[i]) for i, name in enumerate(STATS_NAMES)}
    _save_json(path, stats_dict)
    return path


def load_evaluation_stats(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


# ------------------------------------------------------- predictions file
def _submission_path(exp_path: str) -> str:
    return os.path.join(exp_path, CONFIG["paths"]["submission"])


def reset_predictions_file(exp_path: str):
    path = _submission_path(exp_path)
    if os.path.exists(path):
        os.remove(path)


def load_predictions(path_or_exp: str):
    path = (path_or_exp if path_or_exp.endswith(".json")
            else _submission_path(path_or_exp))
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return []


def save_predictions(preds, exp_path: str):
    _save_json(_submission_path(exp_path), preds)


def _save_json(path: str, obj):
    with open(path, "w") as f:
        json.dump(obj, f)
