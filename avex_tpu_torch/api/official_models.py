"""Official ESP-AVES2 model registry entries.

Python-dict equivalent of the packaged YAML specs the reference auto-registers
at import (``avex/api/configs/official_models/*.yml``, loaded by
``avex/models/utils/registry.py:69-96``). Checkpoints are the published
HuggingFace safetensors exports; ``init_config`` values mirror each
checkpoint's training configuration so converted weights drop straight in.
"""

from __future__ import annotations

from typing import Any, Dict

_BEATS_INIT_BASE: Dict[str, Any] = {
    "activation_dropout": 0.0,
    "activation_fn": "gelu",
    "attention_dropout": 0.0,
    "conv_bias": False,
    "conv_pos": 128,
    "conv_pos_groups": 16,
    "deep_norm": True,
    "dropout": 0.0,
    "dropout_input": 0.0,
    "embed_dim": 512,
    "encoder_attention_heads": 12,
    "encoder_embed_dim": 768,
    "encoder_ffn_embed_dim": 3072,
    "encoder_layerdrop": 0.05,
    "encoder_layers": 12,
    "finetuned_model": True,
    "gru_rel_pos": True,
    "input_patch_size": 16,
    "layer_norm_first": False,
    "layer_wise_gradient_decay_ratio": 0.6,
    "max_distance": 800,
    "num_buckets": 320,
    "predictor_class": 527,
    "predictor_dropout": 0.0,
    "relative_position_embedding": True,
    "sample_frequency": 16000.0,
    "num_mel_bins": 128,
    "frame_length": 25.0,
    "frame_shift": 10.0,
    "fbank_mean": 15.41663,
    "fbank_std": 6.55582,
}

_RAW_10S_AUDIO: Dict[str, Any] = {
    "sample_rate": 16000,
    "representation": "raw",
    "normalize": False,
    "target_length_seconds": 10,
    "window_selection": "random",
}

_EFFNET_AUDIO: Dict[str, Any] = {
    "sample_rate": 16000,
    "n_fft": 800,
    "hop_length": 160,
    "win_length": 800,
    "window": "hann",
    "n_mels": 128,
    "representation": "mel_spectrogram",
    "normalize": True,
    "target_length_seconds": 10,
    "window_selection": "random",
}


def _hf(repo: str, filename: str) -> str:
    return f"hf://EarthSpeciesProject/{repo}/{filename}"


def _beats_entry(repo: str, *, label_map: bool, naturelm: bool = False) -> Dict[str, Any]:
    init = dict(_BEATS_INIT_BASE)
    if naturelm:
        init.update(
            {"attention_dropout": 0.1, "dropout": 0.1, "dropout_input": 0.1,
             "layer_wise_gradient_decay_ratio": 1.0}
        )
    spec: Dict[str, Any] = {
        "name": "beats",
        "pretrained": False,
        "init_config": init,
        "audio_config": dict(_RAW_10S_AUDIO),
    }
    if naturelm:
        spec["use_naturelm"] = True
    else:
        spec["fine_tuned"] = True
    entry = {
        "checkpoint_path": _hf(repo, f"{repo}.safetensors"),
        "model_spec": spec,
    }
    if label_map:
        entry["class_mapping_path"] = _hf(repo, "label_map.json")
    return entry


def _eat_entry(repo: str, *, label_map: bool) -> Dict[str, Any]:
    entry = {
        "checkpoint_path": _hf(repo, f"{repo}.safetensors"),
        "model_spec": {
            "name": "eat_hf",
            "pretrained": False,
            "eat_norm_mean": -5.553,
            "eat_norm_std": 4.606,
            "audio_config": dict(_RAW_10S_AUDIO),
        },
    }
    if label_map:
        entry["class_mapping_path"] = _hf(repo, "label_map.json")
    return entry


def _effnet_entry(repo: str, *, label_map: bool) -> Dict[str, Any]:
    entry = {
        "checkpoint_path": _hf(repo, f"{repo}.safetensors"),
        "model_spec": {
            "name": "efficientnet",
            "pretrained": False,
            "efficientnet_variant": "b0",
            "audio_config": dict(_EFFNET_AUDIO),
        },
    }
    if label_map:
        entry["class_mapping_path"] = _hf(repo, "label_map.json")
    return entry


#: Published SHA-256 of each official safetensors export (the reference pins
#: these in tests/unittests/test_official_models_checksums.py:28-40; they are
#: facts about the published files, used to verify download integrity before
#: conversion).
OFFICIAL_MODEL_CHECKSUMS: Dict[str, str] = {
    "esp_aves2_eat_all": "56159edf43111cd81522bee625dd79c43da80ba795bba85bf394ea1ba182c337",
    "esp_aves2_eat_bio": "3d01d4c834683c3b0d098b09535fbc629c042cfd64b442637a4851d9deb4d62c",
    "esp_aves2_effnetb0_all": "a9ab2bf0896493a4bf325dbd739a7fbd58971513ac171bded880a81f7982bdc1",
    "esp_aves2_effnetb0_audioset": "58455bac5346a8c8d705b20210edfd14a5f6151fed9dd61320bda2e31030119c",
    "esp_aves2_effnetb0_bio": "e34db5a8951f28f4d90cb06b396f4a4e716dd79e48a54e672017d832804868d7",
    "esp_aves2_naturelm_audio_v1_beats": "ce2c16141465e11852105eaee4a32bbb4663cfe8cf7a49ddc874ea5c267f78a2",
    "esp_aves2_sl_beats_all": "25dc242853822de6e35228b22c285886162b5f787d162280e0277c010a510e91",
    "esp_aves2_sl_beats_bio": "1881788eb6d059d7b005e1c68235906fcb12bf3a6cde824cec7cbdc34dcb9fc3",
    "esp_aves2_sl_eat_all_ssl_all": "af10ff12eb15b0e1343348d787b4ccb97bd3e4fe11147140c68ba646d64130cc",
    "esp_aves2_sl_eat_bio_ssl_all": "d787a181898e4ca68e0d0fa78dc2de83b27c2bd1648bce476534fc8c5ac2c7d7",
}

#: registry key → {checkpoint_path, class_mapping_path?, model_spec}
OFFICIAL_MODELS: Dict[str, Dict[str, Any]] = {
    "esp_aves2_sl_beats_all": _beats_entry("esp-aves2-sl-beats-all", label_map=True),
    "esp_aves2_sl_beats_bio": _beats_entry("esp-aves2-sl-beats-bio", label_map=True),
    "esp_aves2_naturelm_audio_v1_beats": _beats_entry(
        "esp-aves2-naturelm-audio-v1-beats", label_map=False, naturelm=True
    ),
    "esp_aves2_eat_all": _eat_entry("esp-aves2-eat-all", label_map=False),
    "esp_aves2_eat_bio": _eat_entry("esp-aves2-eat-bio", label_map=False),
    "esp_aves2_sl_eat_all_ssl_all": _eat_entry("esp-aves2-sl-eat-all-ssl-all", label_map=True),
    "esp_aves2_sl_eat_bio_ssl_all": _eat_entry("esp-aves2-sl-eat-bio-ssl-all", label_map=True),
    "esp_aves2_effnetb0_all": _effnet_entry("esp-aves2-effnetb0-all", label_map=True),
    "esp_aves2_effnetb0_audioset": _effnet_entry("esp-aves2-effnetb0-audioset", label_map=False),
    "esp_aves2_effnetb0_bio": _effnet_entry("esp-aves2-effnetb0-bio", label_map=True),
}
