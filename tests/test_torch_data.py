"""The port's data pipeline against the JAX package's.

The same files (tone WAVs at 16 and 44.1 kHz, ``.npy`` clips, noise WAVs and
manifests, written here from seeded numpy) and the same configs go through
``avex_tpu.data`` and ``avex_tpu_torch.data``: datasets item by item,
transforms, the collater with and without noise and mixup, the loader
(shuffle, ``set_epoch``, ``drop_last``, shards, ``num_workers`` 0 and 2) and
``build_dataloaders``. Batches must be equal: ``raw_wav``, ``padding_mask``
and ``label`` bit for bit. The 44.1 kHz clips pass through each package's
own copy of the native windowed-sinc resampler; they too are held to
equality (the two builds of one C++ source agree exactly). Then the configs
(both example YAMLs with CLI patches, the BEANS and BirdSet descriptors, the
esp_data spellings), the tensor helpers of ``ops/audio.py`` against the jnp
ones, ``io``, the eBird taxonomy, and the experiment records.
"""

import csv
import json
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import avex_tpu.configs as jcfg
import avex_tpu.data as jdata
from avex_tpu import io as jio
from avex_tpu._native import decode_audio as jax_decode_audio
from avex_tpu.data import beans as jbeans
from avex_tpu.data import birdset as jbirdset
from avex_tpu.data import data_utils as jdata_utils
from avex_tpu.data import dataset as jdataset
from avex_tpu.data import ebird_taxonomy as jebird
from avex_tpu.data import transforms as jtransforms
from avex_tpu.ops import audio as jaudio
from avex_tpu.utils import experiment_logger as jlogger
from avex_tpu.utils import tracking as jtracking

import avex_tpu_torch.configs as cfg
import avex_tpu_torch.data as data
from avex_tpu_torch import io as pio
from avex_tpu_torch._native import decode_audio
from avex_tpu_torch.data import beans, birdset, data_utils, dataset, ebird_taxonomy, transforms
from avex_tpu_torch.ops import audio
from avex_tpu_torch.utils import experiment_logger, tracking
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

ROOT = Path(__file__).resolve().parents[1]
RUN_YAML = ROOT / "configs/run_configs/beats_supervised_example.yml"
EVAL_YAML = ROOT / "configs/eval_configs/synthetic_benchmark_example.yml"
KEYS = ("raw_wav", "padding_mask", "label")


def _write_wav(path: Path, wav: np.ndarray, sr: int) -> None:
    pcm = np.clip(np.round(wav * 32767), -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


def _tone(rng, seconds: float, sr: int, freq: float) -> np.ndarray:
    t = np.arange(int(seconds * sr)) / sr
    return (0.3 * np.sin(2 * np.pi * freq * t) + 0.02 * rng.standard_normal(t.size)).astype(np.float32)


@pytest.fixture(scope="module")
def local_dir(tmp_path_factory):
    """A ``kind: local`` directory: 16 kHz and 44.1 kHz WAVs of several
    lengths, ``.npy`` clips, a metadata.csv in three classes; and noise WAVs."""
    root = tmp_path_factory.mktemp("local")
    rng = np.random.default_rng(0)
    rows = []
    for i in range(14):
        label = ["bird", "frog", "insect"][i % 3]
        freq = 300.0 * (1 + i % 3)
        if i % 4 == 3:
            name = f"clip{i}.npy"
            np.save(root / name, _tone(rng, 0.8, 16000, freq))
        else:
            sr = 44100 if i % 4 == 1 else 16000
            name = f"clip{i}.wav"
            _write_wav(root / name, _tone(rng, [1.3, 0.6, 1.0][i % 3], sr, freq), sr)
        rows.append({"path": name, "label": label, "caption": f"a {label}"})
    with open(root / "metadata.csv", "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["path", "label", "caption"])
        writer.writeheader()
        writer.writerows(rows)
    noise = root / "noise"
    noise.mkdir()
    for i in range(3):
        _write_wav(noise / f"noise{i}.wav", 0.2 * rng.standard_normal(12000 + 4000 * i).astype(np.float32), 16000)
    return root


def _pair(**fields):
    """The same DatasetConfig in both packages, through their dict path."""
    return jcfg.DatasetConfig(**fields), cfg.DatasetConfig.from_dict(fields)


def _assert_items_equal(ported, reference):
    assert len(ported) == len(reference)
    assert ported.label_names == reference.label_names
    for i in range(len(reference)):
        got, want = ported[i], reference[i]
        assert set(got) == set(want), i
        np.testing.assert_array_equal(got["raw_wav"], want["raw_wav"], err_msg=str(i))
        assert got["label"] == want["label"] and got.get("text_label") == want.get("text_label")


def _assert_batches_equal(ported, reference):
    ported, reference = list(ported), list(reference)
    assert len(ported) == len(reference) > 0
    for got, want in zip(ported, reference):
        for key in KEYS:
            assert isinstance(got[key], torch.Tensor) and got[key].device.type == "cpu", key
            np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
        assert got.get("text_label") == want.get("text_label")


# ---------------------------------------------------------------------------
# datasets and transforms


def test_synthetic_and_local_datasets_match(local_dir):
    for fields in (dict(name="s", kind="synthetic", num_samples=9, num_classes=3, clip_seconds=0.5, seed=4),
                   dict(name="l", kind="local", path=str(local_dir), text_column="caption"),
                   dict(name="l", kind="local", path=str(local_dir), audio_max_length_seconds=0.7)):
        want, got = _pair(**fields)
        ported = dataset.dataset_from_config(got)
        assert isinstance(ported, torch.utils.data.Dataset)
        _assert_items_equal(ported, jdataset.dataset_from_config(want))


def test_resampled_clips_match_the_jax_resampler(local_dir):
    """44.1 kHz → 16 kHz through each package's native decode and resample:
    equal (the tolerance found is 0)."""
    path = str(local_dir / "clip1.wav")
    wav, sr = decode_audio(path)
    want, want_sr = jax_decode_audio(path)
    assert sr == want_sr == 44100
    np.testing.assert_array_equal(wav, want)
    item = dataset.LocalAudioDataset(cfg.DatasetConfig(name="l", path=str(local_dir)))[1]
    ref = jdataset.LocalAudioDataset(jcfg.DatasetConfig(name="l", path=str(local_dir)))[1]
    assert item["raw_wav"].shape == ref["raw_wav"].shape == (int(0.6 * 44100) * 16000 // 44100,)
    np.testing.assert_array_equal(item["raw_wav"], ref["raw_wav"])


def test_manifest_dataset_matches(tmp_path, local_dir):
    rows = [{"path": f"clip{i}.wav", "ebird": ["amerob", "norcar"][: 1 + i % 2]} for i in (0, 1, 2, 4)]
    rows.append({"path": str(local_dir / "clip5.wav"), "ebird": ["houspa"]})  # an absolute path
    manifest = tmp_path / "split.jsonl"
    manifest.write_text("".join(json.dumps(r) + "\n" for r in rows))
    want, got = _pair(name="m", kind="manifest", path=str(manifest), data_root=str(local_dir),
                      label_column="ebird")
    ported, reference = dataset.dataset_from_config(got), jdataset.dataset_from_config(want)
    assert ported.multilabel and reference.multilabel
    _assert_items_equal(ported, reference)


@pytest.mark.parametrize("policy", ["hard", "overlap", "soft"])
def test_concatenated_datasets_match(policy):
    def make(pkg_cfg, pkg_ds, n, classes, seed):
        return pkg_ds.SyntheticAudioDataset(pkg_cfg.DatasetConfig(name="s", kind="synthetic", num_samples=n,
                                                                   num_classes=classes, clip_seconds=0.25,
                                                                   seed=seed))

    classes = (3, 3) if policy == "hard" else (3, 5)
    ported = dataset.ConcatenatedDataset([make(cfg, dataset, 7, classes[0], 1), make(cfg, dataset, 6, classes[1], 2)],
                                         policy=policy)
    reference = jdataset.ConcatenatedDataset(
        [make(jcfg, jdataset, 7, classes[0], 1), make(jcfg, jdataset, 6, classes[1], 2)], policy=policy)
    _assert_items_equal(ported, reference)
    if policy == "hard":
        with pytest.raises(ValueError, match="identical"):
            dataset.ConcatenatedDataset([make(cfg, dataset, 4, 3, 1), make(cfg, dataset, 4, 5, 1)])


def test_relabel_align_and_transforms_match(local_dir):
    def splits(pkg_cfg, pkg_ds):
        a = pkg_ds.SyntheticAudioDataset(pkg_cfg.DatasetConfig(name="a", kind="synthetic", num_samples=8,
                                                               num_classes=2, clip_seconds=0.2))
        b = pkg_ds.LocalAudioDataset(pkg_cfg.DatasetConfig(name="b", path=str(local_dir)))
        return pkg_ds.align_label_spaces([a, None, b])

    got, want = splits(cfg, dataset), splits(jcfg, jdataset)
    assert got[1] is None and isinstance(got[0], dataset.RelabeledDataset)
    for g, w in zip((got[0], got[2]), (want[0], want[2])):
        _assert_items_equal(g, w)
    same = dataset.SyntheticAudioDataset(cfg.DatasetConfig(name="a", kind="synthetic", num_samples=4))
    assert dataset.align_label_spaces([same, same]) == [same, same]

    for transform in ({"kind": "rl_subsample", "ratio": 0.5, "max_samples": 9, "seed": 3},
                      {"name": "train_val_split", "split": "val", "val_fraction": 0.3},
                      {"kind": "train_val_split", "split": "train", "val_fraction": 0.3}):
        want_cfg, got_cfg = _pair(name="s", kind="synthetic", num_samples=20, num_classes=4, clip_seconds=0.1,
                                  transformations=[transform])
        _assert_items_equal(dataset.dataset_from_config(got_cfg), jdataset.dataset_from_config(want_cfg))
    with pytest.raises(ValueError, match="Unknown dataset transform"):
        dataset.apply_transform(same, {"kind": "nope"})

    base, jbase = (pkg.SyntheticAudioDataset(c.DatasetConfig(name="s", kind="synthetic", num_samples=6,
                                                             num_classes=3, clip_seconds=0.1))
                   for pkg, c in ((dataset, cfg), (jdataset, jcfg)))
    _assert_items_equal(transforms.FillLabelsFromAnswer(base, answer_key="text_label"),
                        jtransforms.FillLabelsFromAnswer(jbase, answer_key="text_label"))
    _assert_items_equal(transforms.TextLabelFromFeatures(base, ["missing"]),
                        jtransforms.TextLabelFromFeatures(jbase, ["missing"]))
    items = [{"label": i % 3, "a": "x", "b": str(i)} for i in range(11)]
    assert data_utils.balance_by_attribute(items, seed=2) == jdata_utils.balance_by_attribute(items, seed=2)
    got_items, want_items = [dict(x) for x in items], [dict(x) for x in items]
    data_utils.combine_text_labels(got_items, ["a", "b"])
    jdata_utils.combine_text_labels(want_items, ["a", "b"])
    assert got_items == want_items


# ---------------------------------------------------------------------------
# collation and loading


def _collaters(local_dir, augments, **kwargs):
    """(port Collater, JAX Collater) with the same augmentation dicts."""
    run = dict(model_spec={"name": "beats"}, training_params={"train_epochs": 1, "lr": 1e-3, "batch_size": 4},
               dataset_config={}, output_dir="x", augmentations=augments)
    port = data.Collater(augmentations=cfg.RunConfig.from_dict(run).augmentations, **kwargs)
    return port, jdata.Collater(augmentations=jcfg.RunConfig.model_validate(run).augmentations, **kwargs)


@pytest.mark.parametrize("augment", ["none", "noise", "mixup", "noise+mixup"])
def test_collater_matches_with_augmentations(local_dir, augment):
    augments = []
    if "noise" in augment:
        augments.append({"kind": "noise", "noise_dirs": [str(local_dir / "noise")], "snr_db_range": [-3, 12],
                         "augmentation_prob": 0.7, "mask_signal_prob": 0.2})
    if "mixup" in augment:
        augments.append({"mixup": {"alpha": 0.4, "n_mixup": 2, "augmentation_prob": 0.9}})
    port, ref = _collaters(local_dir, augments, target_len=16000, num_classes=3, dataset_max_len=18000, seed=5)
    items = list(dataset.LocalAudioDataset(cfg.DatasetConfig(name="l", path=str(local_dir), text_column="caption")))
    for seed in range(4):
        got = port(items, rng=np.random.default_rng(seed))
        want = ref(items, rng=np.random.default_rng(seed))
        for key in KEYS:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{key} seed {seed}")
        assert got["text_label"] == want["text_label"]
    # without a generator each collater draws from its own seeded one
    for key in KEYS:
        np.testing.assert_array_equal(port(items)[key], ref(items)[key])
    eval_port, eval_ref = _collaters(local_dir, augments, target_len=8000, num_classes=3, multilabel=True,
                                     train=False)
    assert not eval_port.item_augments and not eval_port.batch_augments and eval_port.window_selection == "center"
    for key in KEYS:
        np.testing.assert_array_equal(eval_port(items)[key], eval_ref(items)[key])


@pytest.mark.parametrize("num_workers", [0, 2])
def test_loader_batches_equal_jax(local_dir, num_workers):
    """Shuffled and not, ``drop_last`` and not, two shards, two epochs."""
    fields = dict(name="l", kind="local", path=str(local_dir), text_column="caption")
    ds, jds = dataset.dataset_from_config(cfg.DatasetConfig(**fields)), jdataset.dataset_from_config(
        jcfg.DatasetConfig(**fields))
    augments = [{"kind": "noise", "noise_dirs": [str(local_dir / "noise")], "snr_db_range": [0, 10],
                 "augmentation_prob": 0.5}, {"kind": "mixup", "alpha": 0.3, "augmentation_prob": 0.5}]
    port_c, ref_c = _collaters(local_dir, augments, target_len=12000, num_classes=3, seed=1)
    for shuffle, drop_last, shard in ((True, True, None), (False, False, None), (True, False, 1)):
        shards = dict(shard_process=shard, num_shards=2) if shard is not None else {}
        loader = data.DataLoader(ds, 4, port_c, shuffle=shuffle, drop_last=drop_last, seed=7,
                                 num_workers=num_workers, **shards)
        ref = jdata.DataLoader(jds, 4, ref_c, shuffle=shuffle, drop_last=drop_last, seed=7, **shards)
        for epoch in (0, 1):
            loader.set_epoch(epoch)
            ref.set_epoch(epoch)
            assert len(loader) == len(ref)
            _assert_batches_equal(loader, ref)
    assert loader.batches_served == 2 * len(loader) and loader.wait_seconds > 0


def test_loader_workers_persist_and_stop_with_the_loader(local_dir):
    """Spawned workers take the dataset and collater by pickle and give the
    batches of the calling process; they serve every epoch and stop when the
    loader is dropped."""
    ds = dataset.LocalAudioDataset(cfg.DatasetConfig(name="l", path=str(local_dir)))
    collater = data.Collater(target_len=9000, num_classes=3, augmentations=[
        cfg.NoiseAugment(noise_dirs=[str(local_dir / "noise")], snr_db_range=(0, 5), augmentation_prob=1.0)])
    spawned = data.DataLoader(ds, 5, collater, seed=2, num_workers=2)
    inline = data.DataLoader(ds, 5, collater, seed=2)
    for got, want in zip(spawned, inline, strict=True):
        for key in KEYS:
            assert torch.equal(got[key], want[key]), key
    # an iteration dropped half-way leaves the workers ready for the next epoch
    next(iter(spawned))
    assert len(list(spawned)) == len(inline) == 2
    assert len(torch.multiprocessing.active_children()) == 2
    del spawned  # a dropped loader stops its workers
    assert not torch.multiprocessing.active_children()


def test_build_dataloaders_matches_jax(local_dir):
    """The run config's splits, concat policy, augmentations and target
    length through both ``build_dataloaders``."""
    raw = {
        "model_spec": {"name": "beats", "pretrained": False,
                       "audio_config": {"representation": "raw", "target_length_seconds": 0.75}},
        "training_params": {"train_epochs": 1, "lr": 1e-3, "batch_size": 4},
        "dataset_config": {
            "train_datasets": [{"name": "l", "kind": "local", "path": str(local_dir)},
                               {"name": "s", "kind": "synthetic", "num_samples": 6, "num_classes": 5}],
            "val_datasets": [{"name": "v", "kind": "local", "path": str(local_dir)}],
            "concatenate_method": "soft", "concatenate_train": True,
        },
        "augmentations": [{"noise": {"noise_dirs": [str(local_dir / "noise")], "snr_db_range": [0, 10],
                                     "augmentation_prob": 0.8}},
                          {"mixup": {"alpha": 0.5, "augmentation_prob": 0.6}}],
        "output_dir": "unused", "num_workers": 0, "seed": 3,
    }
    port = data.build_dataloaders(cfg.RunConfig.from_dict(dict(raw, device="cpu")))
    ref = jdata.build_dataloaders(jcfg.RunConfig.model_validate(raw))
    assert port[3:] == ref[3:] and port[2] is None and ref[2] is None
    for loader, want in zip(port[:2], ref[:2]):
        assert not loader.pin_memory  # a CPU run's batches are not pinned
        _assert_batches_equal(loader, want)
    # data_pipeline="grain": the checkpointable loader, grain's batches (JAX's grain pipeline)
    grain_port = data.build_dataloaders(cfg.RunConfig.from_dict(dict(raw, device="cpu", data_pipeline="grain")))
    grain_ref = jdata.build_dataloaders(jcfg.RunConfig.model_validate(dict(raw, data_pipeline="grain")))
    assert grain_port[3:] == grain_ref[3:]
    for loader, want in zip(grain_port[:2], grain_ref[:2]):
        assert isinstance(loader, data.GrainDataLoader)
        _assert_batches_equal(loader, want)
    with pytest.raises(ValueError, match="No datasets"):
        data.build_dataloaders(cfg.RunConfig.from_dict(dict(raw, dataset_config={})))


# ---------------------------------------------------------------------------
# configs


def _common(port: dict, reference: dict, path: str = ""):
    """Every field the port has equals the JAX package's dump of it."""
    for key, value in port.items():
        assert key in reference, f"{path}{key}"
        want = reference[key]
        if isinstance(value, dict) and isinstance(want, dict):
            _common(value, want, f"{path}{key}.")
        elif isinstance(value, list) and value and isinstance(value[0], dict):
            assert len(value) == len(want), f"{path}{key}"
            for i, (v, w) in enumerate(zip(value, want)):
                _common(v, w, f"{path}{key}[{i}].")
        elif key != "device":  # cuda, not tpu
            assert value == want, f"{path}{key}: {value!r} != {want!r}"


@pytest.mark.parametrize("patches", [[], ["training_params.lr=3e-4", "model_spec.init_config.dropout=0.0",
                                          "num_workers=2", "augmentations=[{mixup: {alpha: 0.2, "
                                          "augmentation_prob: 0.5}}]"]])
def test_run_config_yaml_and_patches_match(patches):
    got = cfg.RunConfig.from_sources(RUN_YAML, patches)
    want = jcfg.RunConfig.from_sources(RUN_YAML, patches)
    _common(got.to_dict(), want.model_dump(mode="json"))
    assert got.device == got.model_spec.device == "cuda"
    assert json.loads(json.dumps(got.to_dict())) == got.to_dict()
    assert got.replace(device="cpu").dataset_config == got.dataset_config


@pytest.mark.parametrize("patches", [[], ["device=cpu", "eval_modes=[probe]", "training_params.batch_size=4",
                                          "offline_embeddings.overwrite_embeddings=true"]])
def test_evaluate_config_yaml_and_patches_match(patches):
    got = cfg.EvaluateConfig.from_sources(EVAL_YAML, patches)
    want = jcfg.EvaluateConfig.from_sources(EVAL_YAML, patches)
    _common(got.to_dict(), want.model_dump(mode="json"))
    assert got.device == ("cpu" if patches else "cuda")  # the YAML's tpu is the accelerator
    assert isinstance(got.experiments[0].run_config, cfg.RunConfig)


def test_nested_config_paths_and_reference_spellings(tmp_path):
    (tmp_path / "data.yml").write_text("train_datasets:\n  - {name: a, kind: synthetic}\nval_datasets: null\n")
    (tmp_path / "run.yml").write_text("model_spec: {name: beats}\ntraining_params: {train_epochs: 1, lr: 1.0, "
                                      f"batch_size: 2}}\ndataset_config: {tmp_path / 'data.yml'}\noutput_dir: o\n")
    (tmp_path / "eval.yml").write_text(
        "experiments:\n  - {run_name: r, run_config: run.yml, layers: last_layer, frozen: false}\n"
        "dataset_config: {benchmark_name: b, evaluation_sets: [{name: e, validation: {dataset_name: x, "
        "split: y, multi_label: true, extra_knob: 3}}]}\nsave_dir: s\n")
    got = cfg.EvaluateConfig.from_sources(tmp_path / "eval.yml")
    want = jcfg.EvaluateConfig.from_sources(tmp_path / "eval.yml")
    _common(got.to_dict(), want.model_dump(mode="json"))
    val = got.dataset_config.evaluation_sets[0].val
    assert got.dataset_config.evaluation_sets[0].multilabel and val.name == "x_y" and val.extra_knob == 3
    assert got.experiments[0].probe_config.freeze_backbone is False
    with pytest.raises(ValueError, match="augmentation kind"):
        cfg.RunConfig.from_dict(dict(model_spec={"name": "beats"}, output_dir="o", augmentations=[{"kind": "x"}],
                                     training_params={"train_epochs": 1, "lr": 1.0, "batch_size": 2}))
    with pytest.raises(ValueError, match="eval_modes"):
        cfg.EvaluateConfig(experiments=[], dataset_config={}, save_dir="s", eval_modes=["nope"])


def test_descriptors_match():
    for got, want in zip(beans.beans_evaluation_sets() + birdset.birdset_evaluation_sets(),
                         jbeans.beans_evaluation_sets() + jbirdset.birdset_evaluation_sets(), strict=True):
        _common(got.to_dict(), want.model_dump(mode="json"))
    _common(birdset.birdset_train_config("POW-train").to_dict(),
            jbirdset.birdset_train_config("POW-train").model_dump(mode="json"))
    assert birdset.LEGACY_SPLIT_PATHS == jbirdset.LEGACY_SPLIT_PATHS
    with pytest.raises(LookupError):
        birdset.birdset_train_config("nope")
    for stanza in ({"dataset_name": "beans", "split": "dogs_train"}, {"dataset_name": "birdset", "split": "POW-test"},
                   {"dataset_name": "birdset_train", "split": "HSN-validation"}):
        _common(cfg.DatasetConfig(**stanza).to_dict(), jcfg.DatasetConfig(**stanza).model_dump(mode="json"))


def test_ebird_taxonomy_is_the_same_release():
    for version in ebird_taxonomy.SUPPORTED_VERSIONS:
        mine = ROOT / f"avex_tpu_torch/data/assets/ebird_taxonomy_{version}.json"
        assert mine.read_bytes() == (ROOT / f"avex_tpu/data/assets/ebird_taxonomy_{version}.json").read_bytes()
    assert ebird_taxonomy.ebird_code_to_name("amerob") == jebird.ebird_code_to_name("amerob")
    assert ebird_taxonomy.ebird_code_to_name("amerob", "sci") == jebird.ebird_code_to_name("amerob", "sci")


# ---------------------------------------------------------------------------
# ops/audio on tensors, io, records


@pytest.mark.parametrize("length", [700, 1000, 1300])
def test_tensor_audio_helpers_match_jnp(length):
    rng = np.random.default_rng(length)
    wav = rng.standard_normal((2, length)).astype(np.float32)
    for selection in ("center", "start"):
        got = audio.pad_or_window(torch.from_numpy(wav), 1000, selection)
        want = jaudio.pad_or_window(jnp.asarray(wav), 1000, selection)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    got, mask = audio.pad_or_window(torch.from_numpy(wav), 1000, "random", generator=torch.Generator().manual_seed(0))
    assert got.shape == (2, 1000) and bool(mask.any()) == (length < 1000)
    samples = rng.random((3, length)) > 0.3
    np.testing.assert_array_equal(audio.waveform_to_frame_mask(torch.from_numpy(samples), 160).numpy(),
                                  np.asarray(jaudio.waveform_to_frame_mask(jnp.asarray(samples), 160)))
    spec = rng.standard_normal((2, length // 10, 8)).astype(np.float32)
    frames = rng.random((2, length // 10)) > 0.5
    got = audio.sync_crop_or_pad_time(torch.from_numpy(spec), torch.from_numpy(frames), 100)
    want = jaudio.sync_crop_or_pad_time(jnp.asarray(spec), jnp.asarray(frames), 100)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    frames = rng.random((2, 64)) > 0.4
    np.testing.assert_array_equal(audio.frame_mask_to_patch_mask(torch.from_numpy(frames), 16, 128).numpy(),
                                  np.asarray(jaudio.frame_mask_to_patch_mask(jnp.asarray(frames), 16, 128)))


def test_io_local_paths(tmp_path):
    path = str(tmp_path / "a" / "b.txt")
    pio.write_text(path, "héllo")
    assert pio.exists(path) and pio.read_text(path) == jio.read_text(path) == "héllo"
    pio.write_bytes(path, b"\x00\x01")
    assert pio.read_bytes(path) == b"\x00\x01" and not pio.exists(str(tmp_path / "missing"))
    for p in ("gs://b/k", "s3://b/k", "r2://b/k", "hf://x", "https://x", "/tmp/x", "x.yml"):
        assert pio.is_remote(p) == jio.is_remote(p)


def test_experiment_records_match(tmp_path, monkeypatch):
    monkeypatch.setattr("time.strftime", lambda *_: "2026-01-01T00:00:00")
    results = [{"experiment": "e", "evaluation_set": s, "probe_info": {"probe_type": "linear"},
                "metrics": {"probe": {"test_accuracy": 0.5 + i, "test_loss": np.float32(1.5)},
                            "retrieval": {"roc_auc": 0.7}, "duration_seconds": 2.0}}
               for i, s in enumerate(("a", "b"))]
    for pkg, name in ((tracking, "port"), (jtracking, "jax")):
        out = tmp_path / name
        for r in results:
            pkg.append_jsonl(out / "evaluation_metadata.jsonl", dict(r, run_id="x"))
        pkg.create_experiment_summary_csvs(results, out, global_csv_path=out / "global.csv")
        pkg.save_experiment_metadata(out, {"run_name": "r", "lr": 0.1}, "best_model", {"acc": 0.5}, is_best=True)
        pkg.save_experiment_metadata(out, {"run_name": "r"}, "final_model", {"loss": 1.0}, is_final=True)
    for rel in ("evaluation_metadata.jsonl", "summary.csv", "summary_simple.csv", "summaries/a.csv", "global.csv",
                "metadata/experiment_metadata.csv"):
        assert (tmp_path / "port" / rel).read_text() == (tmp_path / "jax" / rel).read_text(), rel
    assert tracking.read_jsonl(tmp_path / "port" / "evaluation_metadata.jsonl") == jtracking.read_jsonl(
        tmp_path / "jax" / "evaluation_metadata.jsonl")
    rows = tracking.load_experiment_metadata(tmp_path / "port")
    assert rows == jtracking.load_experiment_metadata(tmp_path / "jax")
    assert tracking.get_config_from_metadata(rows) == jtracking.get_config_from_metadata(rows) == {"run_name": "r"}


@pytest.mark.parametrize("backend", ["none", "mlflow", "wandb"])
def test_experiment_logger_keeps_the_local_record(tmp_path, backend):
    """mlflow and wandb are absent here: both loggers fall back to the local
    JSONL, with the same lines."""
    for pkg, name in ((experiment_logger, "port"), (jlogger, "jax")):
        log = pkg.ExperimentLogger(backend=backend, output_dir=str(tmp_path / name))
        assert log.backend == "none"
        log.log_params({"lr": 1e-3, "layers": ("a", 1), "obj": object})
        log.log_metrics({"loss": np.float32(0.25), "name": "x", "acc": 1}, step=3, split="val")
        log.finalize()
    got = (tmp_path / "port" / "metrics.jsonl").read_text().splitlines()
    want = (tmp_path / "jax" / "metrics.jsonl").read_text().splitlines()
    assert got == want and len(got) == 2 and json.loads(got[1])["metrics"] == {"val/loss": 0.25, "val/acc": 1.0}
