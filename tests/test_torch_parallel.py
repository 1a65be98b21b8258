"""The port's ``parallel`` package against the JAX package's, in one process.

The rules that need no second process: SLURM discovery, the ZeRO-3
placement rule on every parameter of a small BEATs and EAT (against JAX's
``fsdp_sharding`` on a 2-way mesh of JAX's CPU devices in this process), the block
stitching, ``MeshConfig``, the mesh of one process, each rank's loader
shard from ``build_dataloaders`` (a world of two given to both packages)
against JAX's, and the rule by which the data-parallel CLIP checks leave
the zero-gradient BatchNorm biases out. The two-process tests are in
``tests/test_torch_parallel_training.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

import avex_tpu
import avex_tpu.data as jax_data
from avex_tpu import configs as jcfg
from avex_tpu import parallel as jax_parallel

import avex_tpu_torch
import avex_tpu_torch.data as data
from avex_tpu_torch import configs as cfg
from avex_tpu_torch import parallel
from avex_tpu_torch.models import beats, eat
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

SMALL = {
    "beats": {"encoder_layers": 2, "encoder_embed_dim": 128, "encoder_ffn_embed_dim": 256,
              "encoder_attention_heads": 2, "embed_dim": 64},
    "eat_hf": {"depth": 2, "dim": 128, "heads": 2, "target_length": 64},
}


def test_first_slurm_node_parses_jax_cases():
    for nodelist in ("node[001-004]", "gpu-a[3,17]", "tpu-pod-1", "a1,a2", "n[5],m[7]", "localhost"):
        assert parallel._first_slurm_node(nodelist) == jax_parallel._first_slurm_node(nodelist)
    assert parallel._first_slurm_node("node[001-004]") == "node001"


def test_discover_slurm_and_single_process_start(monkeypatch):
    for key in ("SLURM_PROCID", "SLURM_NTASKS", "SLURM_NODELIST", "SLURM_JOB_ID"):
        monkeypatch.delenv(key, raising=False)
    assert parallel._discover_slurm() is None and jax_parallel._discover_slurm() is None
    assert parallel.init_multihost() is False  # no SLURM: one process, nothing starts
    monkeypatch.setenv("SLURM_PROCID", "3")
    monkeypatch.setenv("SLURM_NTASKS", "8")
    monkeypatch.setenv("SLURM_NODELIST", "gpu-a[3,17]")
    monkeypatch.setenv("SLURM_JOB_ID", "123456")
    assert parallel._discover_slurm() == jax_parallel._discover_slurm() == {
        "coordinator_address": "gpu-a3:13456", "num_processes": 8, "process_id": 3}
    monkeypatch.setenv("SLURM_NTASKS", "many")
    assert parallel._discover_slurm() is None and jax_parallel._discover_slurm() is None
    assert parallel.init_multihost("localhost:1234", num_processes=1, process_id=0) is False
    assert not torch.distributed.is_initialized()


def _jax_axis(shape, mesh, min_size):
    spec = jax_parallel.fsdp_sharding(tuple(shape), mesh, min_size).spec
    return spec.index("data") if "data" in spec else None


@pytest.mark.parametrize("name", list(SMALL))
@pytest.mark.parametrize("min_size", [2**16, 1024])
def test_fsdp_sharding_matches_jax_on_every_parameter(name, min_size):
    jax_mesh = jax_parallel.make_mesh(data=2, model=1, devices=jax.devices()[:2])
    mesh = parallel.Mesh(size=2, rank=0, group=None, device=torch.device("cpu"))
    spec = cfg.ModelSpec(name=name, pretrained=False, init_config=SMALL[name], device="cpu")
    port = avex_tpu_torch.build_model_from_spec(spec, num_classes=4)
    jax_model = avex_tpu.build_model_from_spec(jcfg.ModelSpec(name=name, pretrained=False,
                                                              init_config=SMALL[name]), num_classes=4)
    jax_shapes = [np.shape(x) for x in jax.tree_util.tree_leaves(jax_model.variables["params"])]
    port_shapes = [tuple(p.shape) for p in port.module.parameters()]
    cut = 0
    for shape in jax_shapes + port_shapes:  # the rule, on both packages' layouts
        axis = parallel.fsdp_sharding(shape, mesh, min_size)
        assert axis == _jax_axis(shape, jax_mesh, min_size), shape
        cut += axis is not None
    assert cut > 0 or min_size == 2**16
    # a parameter and its JAX leaf are cut along an axis of the same length
    module = beats if name == "beats" else eat
    converted = module.params_from_jax(jax.tree_util.tree_map(np.asarray, jax_model.variables["params"]))
    for key, param in port.module.named_parameters():
        if key not in converted:
            continue
        got = parallel.fsdp_sharding(tuple(param.shape), mesh, min_size)
        assert (got is None) == (parallel.fsdp_sharding(converted[key].shape, mesh, min_size) is None), key


def test_stitch_local_blocks_matches_jax():
    rng = np.random.default_rng(0)
    full = rng.standard_normal((4, 6)).astype(np.float32)
    cases = [
        {((0, 2), (0, 6)): full[:2], ((2, 4), (0, 6)): full[2:]},  # rows
        {((0, 4), (3, 6)): full[:, 3:], ((0, 4), (0, 3)): full[:, :3]},  # a trailing axis, out of order
        {((0, 2), (0, 3)): full[:2, :3], ((0, 2), (3, 6)): full[:2, 3:], ((2, 4), (0, 3)): full[2:, :3],
         ((2, 4), (3, 6)): full[2:, 3:]},  # both axes
        {((0, 4), (0, 6)): full},
    ]
    for blocks in cases:
        np.testing.assert_array_equal(parallel.stitch_local_blocks(blocks, full.shape, full.dtype),
                                      jax_parallel.stitch_local_blocks(blocks, full.shape, full.dtype))
    for bad in ({((0, 2), (0, 6)): full[:2], ((2, 3), (0, 6)): full[2:3], ((3, 4), (0, 3)): full[3:, :3]},
                {((0, 2), (0, 3)): full[:2, :3], ((2, 4), (3, 6)): full[2:, 3:]}):
        with pytest.raises(ValueError):
            parallel.stitch_local_blocks(bad, full.shape, full.dtype)
        with pytest.raises(ValueError):
            jax_parallel.stitch_local_blocks(bad, full.shape, full.dtype)
    x = torch.arange(6)
    assert parallel.local_array(x) is x


def test_mesh_config_has_the_jax_fields():
    port, ref = cfg.MeshConfig(), jcfg.MeshConfig()
    assert [f.name for f in dataclasses.fields(port)] == list(jcfg.MeshConfig.model_fields)
    assert dataclasses.asdict(port) == ref.model_dump()
    assert cfg.MeshConfig(axis_names=["x", "y"]).axis_names == ("x", "y")
    fsdp = cfg.MeshConfig(param_sharding="fsdp", fsdp_min_size="1024")
    assert fsdp.fsdp_min_size == 1024 and jcfg.MeshConfig(param_sharding="fsdp").param_sharding == "fsdp"
    with pytest.raises(ValueError, match="param_sharding"):
        cfg.MeshConfig(param_sharding="zero")
    with pytest.raises(ValueError):
        jcfg.MeshConfig(param_sharding="zero")
    for part_2 in ({"model": 2}, {"pipeline_microbatches": 2}, {"sequence_parallel": True}):
        # the model axis's options build as JAX's do (the Trainer checks their combinations)
        assert dataclasses.asdict(cfg.MeshConfig(**part_2)) == jcfg.MeshConfig(**part_2).model_dump()
    run = cfg.RunConfig(model_spec={"name": "beats"}, output_dir="unused", mesh={"param_sharding": "fsdp"},
                        training_params={"train_epochs": 1, "lr": 1e-3, "batch_size": 2})
    assert run.mesh == cfg.MeshConfig(param_sharding="fsdp") and run.to_dict()["mesh"]["data"] == -1


def test_one_process_mesh_and_its_helpers():
    mesh = parallel.make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.distributed, mesh.axis_names) == (1, 0, False, ("data", "model"))
    with pytest.raises(ValueError, match="model=2"):  # a model axis of 2 needs two processes
        parallel.make_mesh(model=2, device="cpu")
    with pytest.raises(ValueError, match="processes"):
        parallel.make_mesh(data=2, device="cpu")
    assert parallel.world_size() == 1 and parallel.is_main_process() and parallel.local_device_count() == 1
    assert parallel.rank_device("cuda") == torch.device("cuda") and parallel.rank_device("cpu").type == "cpu"
    assert parallel.gather_metrics({"loss": 2.0}) == {"loss": 2.0}
    batch = parallel.shard_batch({"raw_wav": np.zeros((2, 4), np.float32), "text_label": ["a", "b"],
                                  "label": np.arange(2), "padding_mask": None}, mesh)
    assert sorted(batch) == ["label", "raw_wav"] and batch["raw_wav"].device.type == "cpu"
    with parallel.global_batch(mesh, torch.Generator()):  # one rank: the local batch is the global one
        assert parallel.batch_mesh() is None
        generator = torch.Generator()
        assert parallel.shared_generator(generator) is generator


def _run_configs(tmp_path):
    datasets = {"train_datasets": [{"name": "s", "kind": "synthetic", "num_samples": 11, "num_classes": 3}],
                "val_datasets": [{"name": "v", "kind": "synthetic", "num_samples": 9, "num_classes": 3}]}
    common = dict(model_spec={"name": "beats", "pretrained": False},
                  training_params={"train_epochs": 1, "lr": 1e-3, "batch_size": 2}, output_dir=str(tmp_path),
                  dataset_config=datasets, num_workers=0, seed=3)
    return cfg.RunConfig.from_dict(dict(common, device="cpu")), jcfg.RunConfig(**common)


@pytest.mark.parametrize("rank", [0, 1])
def test_each_rank_loads_the_jax_shard(tmp_path, monkeypatch, rank):
    """``build_dataloaders`` in a world of two: the rank's strided slice of
    the epoch's permutation, remainders dropped on every split, the same
    collated batches as the JAX package's (its process count and index
    given the same world)."""
    port_config, jax_config = _run_configs(tmp_path)
    monkeypatch.setattr(data, "world_size", lambda: 2)
    monkeypatch.setattr(data.dist, "get_rank", lambda: rank)
    monkeypatch.setattr(jax_data.jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax_data.jax, "process_index", lambda: rank)
    port_loaders = data.build_dataloaders(port_config)
    jax_loaders = jax_data.build_dataloaders(jax_config)
    for port_loader, jax_loader in zip(port_loaders[:2], jax_loaders[:2]):
        assert (port_loader.shard_process, port_loader.num_shards, port_loader.drop_last) == (rank, 2, True)
        for epoch in (0, 1):
            port_loader.set_epoch(epoch)
            jax_loader.set_epoch(epoch)
            chunks = [c.tolist() for c in port_loader._chunks()]
            assert chunks == [c.tolist() for c in jax_loader._chunks()]
            full = np.random.default_rng(3 * 1_000_003 + epoch).permutation(len(port_loader.dataset)) \
                if port_loader.shuffle else np.arange(len(port_loader.dataset))
            mine = full[rank::2]
            assert sum(chunks, []) == mine[:len(mine) - len(mine) % 2].tolist()
            for got, want in zip(port_loader, jax_loader):
                for key in ("raw_wav", "label", "padding_mask"):
                    np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)


def test_projection_batchnorm_biases_have_no_gradient_in_train_mode():
    """The rule by which the data-parallel CLIP checks leave tensors out of
    their gradient comparison (``chip_smoke.shift_free_biases``): in train
    mode, the shift that an MBConv's projection BatchNorm bias adds reaches
    the loss only through 1x1 convolutions into the next BatchNorm, whose
    batch mean takes it away. In float64 their gradients vanish next to
    every other bias's."""
    from avex_tpu_torch.models import efficientnet as eff
    from chip_smoke import shift_free_biases

    torch.manual_seed(0)
    model = eff.EfficientNetModel("b0", 7, torch.float64).double().train()
    out, _ = model(torch.randn(4, 3, 64, 50, dtype=torch.float64), deterministic=True)
    loss = torch.nn.functional.cross_entropy(out, torch.tensor([1, 2, 3, 0]))
    params = dict(model.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    free = shift_free_biases(grads)
    assert len(free) == 16 and "features.1.0.block.2.1.bias" in free  # one per MBConv; stage 1 has no expansion
    others = [float(g.abs().max()) for n, g in grads.items() if n.endswith("bias") and n not in free]
    assert max(float(grads[n].abs().max()) for n in free) <= 1e-12 * min(others)


def test_tensor_parallelism_cuts_only_what_a_layer_runs():
    """A tensor cut over the model axis must lie under a module whose
    ``use_model_axis`` hook runs its part (nothing else sums its input's
    gradient over the axis): a bare ``fc1`` raises; CLIP's projection cuts
    fc1 on its outputs and fc2 on its inputs, as ``_tp_shard_params`` does,
    and names fc1's bias as read in part. No collective runs to build it."""
    from avex_tpu_torch.models.clip import _Projection
    from avex_tpu_torch.parallel.tensor import TensorParallelLayout

    mesh = parallel.Mesh(size=1, rank=0, group=None, device=torch.device("cpu"), model_size=2, model_rank=1)
    bare = torch.nn.Module()
    bare.fc1 = torch.nn.Linear(4, 8)
    with pytest.raises(ValueError, match=r"\['fc1.weight'\] in no module with a use_model_axis hook"):
        TensorParallelLayout(bare, mesh)
    projection = _Projection(4, 8, 6)
    whole = {k: v.clone() for k, v in projection.state_dict().items()}
    layout = TensorParallelLayout(projection, mesh)
    assert layout.cut == {"fc1.weight": 0, "fc2.weight": 1} and layout.partial == {"fc1.bias"}
    assert torch.equal(projection.fc1.weight, whole["fc1.weight"][4:])
    assert torch.equal(projection.fc2.weight, whole["fc2.weight"][:, 4:])
    assert torch.equal(projection.fc1.bias, whole["fc1.bias"]) and projection.model_axis is layout.axis
