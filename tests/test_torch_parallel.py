"""parallel/mesh.py without processes, against the reference's
parallel/mesh.py: ``pad_batch_to``, ``MeshConfig``'s factoring and its
errors, the 1 x 1 mesh without a process group, the row bookkeeping, and
``rtdetr_decoder_tp``'s plan against the reference's specs leaf for leaf
(tests/test_torch_multiprocess.py runs the plan on two processes).

The plan check maps the reference's decoder-layer leaves through
models/convert.py's own key map: every leaf is filled with markers
(its id and each element's flat index, in float64), converted into the
port's tensors, and for each model index the markers in the port's shard
(``mesh.take_shard`` of the plan's Shard) must be exactly those of the
reference's shard of the leaves it came from (a split along the
reference spec's dimension); a replicated port tensor must come from
leaves the reference replicates.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robust_object_detection_tpu.core.config import MeshConfig as JMesh
from robust_object_detection_tpu.models import rtdetr as JR
from robust_object_detection_tpu.parallel import mesh as jmesh
from robust_object_detection_tpu_torch.core.config import MeshConfig
from robust_object_detection_tpu_torch.models import convert
from robust_object_detection_tpu_torch.models import rtdetr as TR
from robust_object_detection_tpu_torch.parallel import mesh as tmesh


@pytest.mark.parametrize("multiple", [1, 2, 3, 8])
def test_pad_batch_to_equals_reference(multiple):
    rng = np.random.RandomState(0)
    batch = (rng.rand(5, 4, 3).astype(np.float32),
             rng.randint(0, 9, (5, 2)).astype(np.int32))
    got = tmesh.pad_batch_to(batch, multiple)
    ref = jmesh.pad_batch_to(batch, multiple)
    assert isinstance(got, tuple) and len(got) == 2
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, np.asarray(r))
        assert g.dtype == np.asarray(r).dtype
    d = tmesh.pad_batch_to({"a": batch[0]}, multiple)
    np.testing.assert_array_equal(d["a"], np.asarray(ref[0]))


@pytest.mark.parametrize("data, model, n", [
    (-1, 1, 8), (-1, 2, 8), (4, 2, 8), (2, 1, 2), (-1, 1, 1), (-1, 4, 4)])
def test_axis_sizes_equal_reference(data, model, n):
    assert MeshConfig(data, model).axis_sizes(n) == \
        JMesh(data, model).axis_sizes(n)


@pytest.mark.parametrize("data, model, n", [(3, 1, 8), (-1, 3, 8),
                                            (2, 2, 2), (-1, 2, 1)])
def test_axis_sizes_errors_equal_reference(data, model, n):
    with pytest.raises(ValueError, match="factor") as got:
        MeshConfig(data, model).axis_sizes(n)
    with pytest.raises(ValueError) as ref:
        JMesh(data, model).axis_sizes(n)
    assert str(got.value) == str(ref.value)


def test_mesh_without_a_process_group_is_one_by_one():
    ctx = tmesh.make_mesh(MeshConfig())
    assert (ctx.n_data, ctx.n_model, ctx.rank) == (1, 1, 0)
    assert not ctx.grouped and ctx.shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="factor"):
        tmesh.make_mesh(MeshConfig(data=1, model=2))
    # every collective is a no-op
    t = torch.arange(4.0)
    with tmesh.data_parallel(ctx):
        assert tmesh.active() is None
        m, q = tmesh.sync_moments(t, t * t)
        assert m is t and tmesh.global_sum(t) is t
        assert tmesh.mean_over_data(t) is t
        assert tmesh.kernel_sync(t) == (None, None)
    assert tmesh.gather_rows(ctx, (t,)) == (t,)
    assert tmesh.broadcast_floats(ctx, [1, 2.5]) == [1.0, 2.5]


def test_rows_and_draws_of_a_data_rank():
    ctx = tmesh.MeshContext(n_data=2, n_model=2, rank=3)
    assert (ctx.data_index, ctx.model_index) == (1, 1)
    assert tmesh.local_rows(ctx, 8) == slice(4, 8)
    assert tmesh.draw_rows(4, ctx) == (8, slice(4, 8))
    assert tmesh.draw_rows(3, None) == (3, slice(0, 3))
    x = np.arange(8)
    np.testing.assert_array_equal(tmesh.shard_batch(ctx, {"x": x})["x"],
                                  x[4:])
    with pytest.raises(ValueError, match="divisible"):
        tmesh.local_rows(ctx, 5)


@pytest.mark.parametrize("spec", [tmesh.Shard(0), tmesh.Shard(1),
                                  tmesh.Shard(0, 3)])
def test_take_shard_round_trip(spec):
    t = torch.arange(48.0).reshape(12, 4)
    parts = [tmesh.take_shard(t, spec, i, 2) for i in range(2)]
    per = [p.chunk(spec.blocks, spec.dim) for p in parts]
    back = torch.cat([torch.cat([p[b] for p in per], spec.dim)
                      for b in range(spec.blocks)], spec.dim)
    assert torch.equal(back, t)


# ── the decoder plan against the reference's specs ───────────────────────

SMALL = dict(queries=24, dec_layers=2)


@pytest.fixture(scope="module")
def reference_layers():
    """The reference's decoder-layer subtrees, each leaf filled with
    markers id * 1e7 + flat index, and the reference's spec of each."""
    cfg = JR.RtDetrConfig(num_classes=6, **SMALL)
    model = JR.RTDETR(cfg)
    shapes = jax.eval_shape(lambda k: model.init(
        k, jnp.zeros((1, 64, 64, 3), jnp.float32)), jax.random.key(0))
    ctx = jmesh.MeshContext(jmesh.make_mesh(JMesh(data=1, model=2)))
    specs = jmesh.rtdetr_decoder_tp(ctx, shapes["params"])
    layers, layer_specs = {}, {}
    leaf_id = [0]

    def fill(s):
        leaf_id[0] += 1
        n = int(np.prod(s.shape))
        return (leaf_id[0] * 1e7 + np.arange(n, dtype=np.float64)
                ).reshape(s.shape)
    for li in range(cfg.dec_layers):
        name = f"layer{li}"
        layers[name] = jax.tree.map(fill, shapes["params"][name])
        layer_specs[name] = jax.tree.map(lambda sh: sh.spec, specs[name])
    return cfg, layers, layer_specs


def _port_layer(layer):
    """The converter's key map for one decoder layer (its own _mha /
    _dense / _ln, as rtdetr_from_jax_variables applies them), markers kept
    in float64."""
    real = convert._t
    convert._t = lambda a: torch.from_numpy(np.array(a))
    try:
        sd = {}
        convert._mha(sd, "L.self_attn", layer["self_attn"])
        for sub in ("sampling_offsets", "attention_weights", "value_proj",
                    "output_proj"):
            convert._dense(sd, f"L.cross_attn.{sub}",
                           layer["cross_attn"][sub])
        for sub in ("norm1", "norm2", "norm3"):
            convert._ln(sd, f"L.{sub}", layer[sub])
        convert._dense(sd, "L.linear1", layer["linear1"])
        convert._dense(sd, "L.linear2", layer["linear2"])
    finally:
        convert._t = real
    return {k[len("model.L."):]: v for k, v in sd.items()}


def _leaf_shard(a: np.ndarray, spec, index: int, size: int) -> set:
    """The markers of the reference's shard `index` of a leaf."""
    dims = [d for d, ax in enumerate(spec) if ax == "model"]
    if not dims:
        return set(a.ravel().tolist())
    return set(np.split(a, size, axis=dims[0])[index].ravel().tolist())


def test_decoder_plan_matches_reference_specs(reference_layers):
    cfg, layers, layer_specs = reference_layers
    port = TR.create(6, device=torch.device("cpu"), **SMALL)
    plan = tmesh.rtdetr_decoder_tp(None, port)
    names = [n for n, _ in port.named_parameters()]
    assert plan.keys() == set(names)
    sharded = {n for n, s in plan.items() if s is not None}
    prefix = "model.28.decoder.layers."
    assert sharded and all(n.startswith(prefix) for n in sharded)
    assert len(sharded) == 6 * cfg.dec_layers
    leaves_checked = 0
    for li in range(cfg.dec_layers):
        leaves = {id_: (a, s) for id_, (a, s) in enumerate(zip(
            jax.tree.leaves(layers[f"layer{li}"]),
            jax.tree.leaves(layer_specs[f"layer{li}"],
                            is_leaf=lambda x: isinstance(
                                x, jax.sharding.PartitionSpec))))}
        by_marker = {int(a.ravel()[0] // 1e7): (a, s)
                     for a, s in leaves.values()}
        for key, t in _port_layer(layers[f"layer{li}"]).items():
            spec = plan[f"{prefix}{li}.{key}"]
            ids = sorted({int(v // 1e7) for v in t.numpy().ravel()})
            src = [by_marker[i] for i in ids]
            if spec is None:
                assert all("model" not in tuple(s) for _, s in src), key
                continue
            for r in range(2):
                mine = set(tmesh.take_shard(t, spec, r, 2).numpy()
                           .ravel().tolist())
                theirs = set().union(*(_leaf_shard(a, s, r, 2)
                                       for a, s in src))
                assert mine == theirs, (key, r)
            leaves_checked += len(src)
    # per layer: q, k, v kernels and biases, out kernel, linear1 kernel and
    # bias, linear2 kernel
    assert leaves_checked == 10 * cfg.dec_layers
