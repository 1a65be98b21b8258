"""Benchmark evaluation entry point: experiments × evaluation sets.

Port of ``avex_tpu/run_evaluate.py``: for every experiment and evaluation
set it computes what the ``eval_modes`` ask for: probe transfer (offline on
cached embeddings, or online through the backbone), retrieval and
clustering. A frozen backbone is built once per experiment and reused
across the sets. Each result is appended to
``<save_dir>/evaluation_metadata.jsonl`` with the experiment's config
snapshot, and the summary CSVs are written at the end.

Backbones, probes and retrieval's similarity products run on
``config.device``: ``cuda`` unless the config names ``cpu``. In a run of
several processes (a process group the caller started, e.g. with
``parallel.init_multihost``) each process takes its card, and extraction
into the cache runs data-parallel over all of them, as the JAX package's
extraction mesh does; rank 0 writes the caches, the JSONL and the CSVs.
Offline probes and retrieval over the cache need ``h5py`` (the HDF5
embedding cache), clustering needs scikit-learn; both are imported only
there, so a machine without them runs ``eval_modes: [probe]`` with an online
probe.

    python -m avex_tpu_torch.run_evaluate --config configs/eval_configs/synthetic_benchmark_example.yml device=cpu
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from avex_tpu_torch.configs import EvaluateConfig, EvaluationSet, ExperimentConfig
from avex_tpu_torch.data import Collater, DataLoader, dataset_from_config
from avex_tpu_torch.data.dataset import align_label_spaces
from avex_tpu_torch.evaluation import (
    HDF5EmbeddingDataset,
    cache_path,
    embedding_cache_matches,
    eval_clustering,
    eval_retrieval,
    eval_retrieval_cross_set,
    extract_embeddings_to_cache,
    load_cached_embeddings,
    train_and_eval_offline,
    train_and_eval_online,
)
from avex_tpu_torch.models.factory import build_model_from_spec
from avex_tpu_torch.models.load import load_model
from avex_tpu_torch.parallel import is_main_process, make_mesh, rank_device, world_size
from avex_tpu_torch.utils.tracking import append_jsonl, create_experiment_summary_csvs

__all__ = ["main", "run_experiment"]

logger = logging.getLogger(__name__)


def _embedding_collate(items: Sequence[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    return {key: np.stack([np.asarray(item[key]) for item in items]) for key in items[0]}


def _raw_loader(dataset, cfg: EvaluateConfig, target_len: int, num_classes: int, train: bool,
                window_selection: str, multilabel: bool = False) -> DataLoader:
    """A loader of raw audio: shuffled with random crops for training,
    center crops otherwise; multilabel rows multi-hot encoded."""
    collater = Collater(target_len=target_len, num_classes=num_classes, window_selection=window_selection,
                        one_hot=True, train=train, multilabel=multilabel)
    return DataLoader(dataset, batch_size=cfg.training_params.batch_size, collate_fn=collater, shuffle=train,
                      drop_last=False, seed=cfg.seed, num_workers=cfg.num_workers,
                      pin_memory=torch.device(cfg.device).type == "cuda")


def _probe_info(probe, probe_cfg, model) -> Dict[str, Any]:
    """Probe metadata kept with each record: type, layers, the parameter
    counts of the probe and the backbone, and the softmaxed learned layer
    weights when the probe mixes several layers."""
    probe_params = sum(p.numel() for p in probe.module.parameters())
    base_params = sum(p.numel() for p in model.module.parameters()) if model is not None else 0
    frozen = bool(getattr(probe, "freeze_backbone", True))
    info: Dict[str, Any] = {
        "probe_type": probe_cfg.probe_type,
        "layers": [str(layer) for layer in probe_cfg.target_layers],
        "probe_trainable": probe_params,
        "probe_total": probe_params,
        "base_trainable": 0 if frozen else base_params,
        "base_total": base_params,
    }
    layer_weights = getattr(probe.module, "layer_weights", None)
    if layer_weights is not None:
        raw = layer_weights.detach().double().cpu().numpy()
        norm = np.exp(raw - raw.max())
        info["layer_weights"] = [float(x) for x in norm / norm.sum()]
    return info


def _extraction_mesh(device: str):
    """The data-parallel mesh of extraction: every process of the run, or
    None for one process."""
    return make_mesh(device=device) if world_size() > 1 else None


def _get_or_compute_embeddings(model, loader, path: Path, aggregation: str, layers,
                               overwrite: bool) -> HDF5EmbeddingDataset:
    layer_names = model.register_hooks_for_layers(list(layers))
    if overwrite or not embedding_cache_matches(path, aggregation, layer_names):
        extract_embeddings_to_cache(model, loader, path, aggregation=aggregation, layers=layers,
                                    mesh=_extraction_mesh(model.device))
    else:
        logger.info("Reusing embedding cache %s", path)
    return HDF5EmbeddingDataset(path)


def run_experiment(experiment: ExperimentConfig, eval_set: EvaluationSet, config: EvaluateConfig,
                   model=None) -> Dict[str, Any]:
    """One experiment on one evaluation set; ``model``: a backbone to reuse."""
    t_start = time.time()
    probe_cfg = experiment.probe_config
    spec = experiment.run_config.model_spec
    online = bool(probe_cfg.online_training) or not probe_cfg.freeze_backbone

    # Datasets on one label space
    splits = {name: dataset_from_config(getattr(eval_set, name)) if getattr(eval_set, name) else None
              for name in ("train", "val", "test")}
    splits = dict(zip(("train", "val", "test"), align_label_spaces([splits[k] for k in ("train", "val", "test")])))
    num_classes = (splits["train"] or splits["test"]).num_classes

    audio_cfg = spec.audio_config
    sr = audio_cfg.sample_rate if audio_cfg else 16000
    target_len = audio_cfg.target_length_samples if audio_cfg and audio_cfg.target_length_samples else sr
    window_selection = audio_cfg.window_selection if audio_cfg else "random"

    # Model: the extraction forward never drops layers
    device = str(rank_device(config.device))
    if model is None:
        if experiment.checkpoint_path or experiment.pretrained:
            model = load_model(spec, device=device, checkpoint_path=experiment.checkpoint_path,
                               return_features_only=True)
        else:
            model = build_model_from_spec(spec, device=device, num_classes=None, return_features_only=True)

    metrics_out: Dict[str, Any] = {}
    probe_info: Dict[str, Any] = {}
    loaders = {name: _raw_loader(ds, config, target_len, num_classes, name == "train", window_selection,
                                 eval_set.multilabel) if ds is not None else None
               for name, ds in splits.items()}
    save_dir = config.offline_embeddings.save_dir or str(Path(config.save_dir) / "embeddings")

    # Probe
    if "probe" in config.eval_modes and splits["train"] is not None:
        if online:
            probe_metrics, trainer = train_and_eval_online(
                probe_cfg, config.training_params, model, loaders["train"], loaders["test"],
                num_classes=num_classes, val_loader=loaders["val"], metrics=eval_set.metrics,
                multilabel=eval_set.multilabel, seed=config.seed)
        else:
            emb_datasets = {}
            for split_name, loader in loaders.items():
                if loader is None:
                    continue
                path = cache_path(save_dir, getattr(eval_set, split_name).name, spec.name, split_name,
                                  probe_cfg.target_layers)
                # extraction for the cache: a deterministic center-crop loader
                det_loader = _raw_loader(splits[split_name], config, target_len, num_classes, False, "center",
                                         eval_set.multilabel)
                emb_datasets[split_name] = _get_or_compute_embeddings(
                    model, det_loader, path, probe_cfg.aggregation, probe_cfg.target_layers,
                    config.offline_embeddings.overwrite)

            def emb_loader(ds, train: bool) -> DataLoader:
                return DataLoader(ds, batch_size=config.training_params.batch_size, collate_fn=_embedding_collate,
                                  shuffle=train, drop_last=False, seed=config.seed,
                                  num_workers=config.probe_num_workers)

            sample = emb_datasets["train"][0]
            input_dims = [tuple(sample[f"embeddings_{i}"].shape) for i in range(emb_datasets["train"].num_layers)]
            probe_metrics, trainer = train_and_eval_offline(
                probe_cfg, config.training_params, emb_loader(emb_datasets["train"], True),
                emb_loader(emb_datasets["test"], False), input_dims=input_dims, num_classes=num_classes,
                val_loader=emb_loader(emb_datasets["val"], False) if emb_datasets.get("val") else None,
                metrics=eval_set.metrics, multilabel=eval_set.multilabel, seed=config.seed, device=device)
        metrics_out["probe"] = {f"test_{k}": v for k, v in probe_metrics.items()}
        probe_info = _probe_info(trainer.probe, probe_cfg, model)

    # Retrieval and clustering over the pooled test embeddings
    if {"retrieval", "clustering"} & set(config.eval_modes) and splits["test"] is not None:
        pooled_layers = probe_cfg.target_layers

        def pooled(split_name: str) -> Tuple[np.ndarray, np.ndarray]:
            path = cache_path(save_dir, getattr(eval_set, split_name).name, spec.name, f"{split_name}_pooled",
                              pooled_layers)
            det_loader = _raw_loader(splits[split_name], config, target_len, num_classes, False, "center",
                                     eval_set.multilabel)
            model.register_hooks_for_layers(list(pooled_layers))
            if config.offline_embeddings.overwrite or not embedding_cache_matches(path, "mean", model._hook_layers):
                extract_embeddings_to_cache(model, det_loader, path, aggregation="mean", layers=pooled_layers,
                                            mesh=_extraction_mesh(device))
            embs, labels, _meta = load_cached_embeddings(path)
            return embs[0], labels

        test_embs, test_labels = pooled("test")
        if "retrieval" in config.eval_modes:
            if eval_set.retrieval_mode == "train_vs_test" and splits["train"] is not None:
                train_embs, train_labels = pooled("train")
                metrics_out["retrieval"] = eval_retrieval_cross_set(train_embs, train_labels, test_embs, test_labels,
                                                                    device=device)
            else:
                metrics_out["retrieval"] = eval_retrieval(test_embs, test_labels, device=device)
        if "clustering" in config.eval_modes:
            metrics_out["clustering"] = eval_clustering(test_embs, test_labels, n_clusters=num_classes,
                                                        seed=config.seed)

    metrics_out["duration_seconds"] = time.time() - t_start
    return {"experiment": experiment.run_name, "evaluation_set": eval_set.name, "metrics": metrics_out,
            "probe_info": probe_info, "model": model}


def main(config: EvaluateConfig) -> List[Dict[str, Any]]:
    """Every experiment on every evaluation set, reusing frozen backbones."""
    save_dir = Path(config.save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    results: List[Dict[str, Any]] = []
    for experiment in config.experiments:
        cached_model = None
        frozen = experiment.probe_config.freeze_backbone
        for eval_set in config.dataset_config.evaluation_sets:
            logger.info("Running %s on %s", experiment.run_name, eval_set.name)
            result = run_experiment(experiment, eval_set, config, model=cached_model)
            model = result.pop("model")
            if frozen:
                cached_model = model  # a frozen backbone serves every set
            results.append(result)
            # the record carries the config: each row can be rebuilt from the JSONL alone
            if is_main_process():
                append_jsonl(save_dir / "evaluation_metadata.jsonl",
                             dict(result, config_snapshot=experiment.to_dict()))
    if is_main_process():
        create_experiment_summary_csvs(results, save_dir, global_csv_path=config.results_csv_path)
    return results


def cli(argv: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    """``--config <yaml>`` plus ``key=value`` patches → :func:`main`."""
    parser = argparse.ArgumentParser(description="Evaluate backbones on benchmark sets.")
    parser.add_argument("--config", "-c", required=True, help="YAML evaluation config")
    parser.add_argument("patches", nargs="*", help="key=value overrides, dotted keys for nested fields")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return main(EvaluateConfig.from_sources(args.config, args.patches))


if __name__ == "__main__":
    cli()
