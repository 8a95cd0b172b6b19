"""Sharding policy: parameter specs + activation constraints.

Port of ``repro/models/sharding.py`` over the port's ``Mesh``
(launch/mesh.py).  One policy object describes how a config maps onto a
(data, model) mesh:

* tensor parallelism ("model" axis): attention head dims, ffn hidden dims,
  MoE experts (expert-parallel when E divides the axis, intra-expert TP
  otherwise), vocab dim of embeddings/head when divisible;
* ZeRO-3 / FSDP ("data" axes, optional): the largest remaining axis of each
  >=2D weight is additionally sharded over the batch axes;
* activation constraints on the residual stream and the logits.

A spec is a tuple with one entry a dimension: None (replicated), an axis
name, or a tuple of axis names, canonicalised as ``PartitionSpec`` does
(``spec``), so it equals the tuple of the reference's spec for the same
leaf.  The specs are computed here and executed by ``models/parallel.py``
(``build_model(cfg).init(mesh=)``, ``convert.lm_params_from_reference(
mesh=)``, the steps' ``policy=``, ``runtime/train_loop.TrainLoop`` in pjit
mode): each leaf is cut into its ranks' shards as ``params_specs`` says,
matched to the port's per-layer leaves through ``tree.reference_path``,
and the decode caches as ``cache_specs`` says: KV heads over the model
axis, or with ``kv_cache_shard="sequence"`` the cache's slots
(flash-decoding: ``layers.attention_decode_tp``), which the reference
places only in its dry run and the port executes.
``constrain_residual`` / ``constrain_logits`` are the identity: the
executor keeps the residual stream whole on each model rank (its batch
split over data) and gathers the logits whole, where the reference may
shard them over the model axis (ROADMAP C).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

from repro_torch.models.config import ModelConfig
from repro_torch.tree import named_leaves, reference_path

Spec = Tuple[Any, ...]


def spec(*entries) -> Spec:
    """A spec as the reference's ``PartitionSpec(*entries)`` canonicalises
    it: a one-name tuple is that name, an empty tuple None."""
    out = []
    for e in entries:
        if isinstance(e, (tuple, list)):
            e = None if not e else e[0] if len(e) == 1 else tuple(e)
        out.append(e)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    mesh: Any
    dp_axes: Tuple[str, ...] = ("data",)
    tp_axis: str = "model"
    fsdp: bool = False
    seq_shard: bool = False

    # --- sizes ----------------------------------------------------------

    @property
    def tp_size(self) -> int:
        return self.mesh.shape[self.tp_axis]

    @property
    def dp_size(self) -> int:
        n = 1
        for a in self.dp_axes:
            n *= self.mesh.shape[a]
        return n

    def _div(self, dim: int, size: int) -> bool:
        return dim % size == 0 and dim >= size

    # --- activation constraints ------------------------------------------

    def constrain_residual(self, x):
        """The identity: the reference constrains (B, S, D) to batch over
        dp (and sequence over tp); one process holds it whole."""
        return x

    def constrain_logits(self, x, vocab_sharded: bool = True):
        """The identity (the reference shards the vocabulary over tp)."""
        return x

    def batch_spec(self, ndim: int) -> Spec:
        return spec(self.dp_axes, *([None] * (ndim - 1)))

    # --- parameter specs --------------------------------------------------

    def param_spec(self, path: str, shape: Tuple[int, ...],
                   cfg: ModelConfig) -> Spec:
        """Spec for one weight.  `path` is the reference's '/'-joined path;
        stacked block weights have a leading L axis, detected via 'blocks'
        in path."""
        stacked = "blocks" in path
        core = shape[1:] if stacked else shape
        out = self._core_spec(path, core, cfg)
        return spec(None, *out) if stacked else out

    def _core_spec(self, path: str, shape: Tuple[int, ...],
                   cfg: ModelConfig) -> Spec:
        tp, ts = self.tp_axis, self.tp_size
        leaf = path.rsplit("/", 1)[-1]

        out: list = [None] * len(shape)
        if leaf in ("embed", "src_embed"):           # (V, D)
            if self._div(shape[0], ts):
                out[0] = tp
            elif self._div(shape[1], ts):
                out[1] = tp
        elif leaf == "lm_head":                       # (D, V)
            if self._div(shape[1], ts):
                out[1] = tp
            elif self._div(shape[0], ts):
                out[0] = tp
        elif leaf in ("wq", "wk", "wv", "w1", "w3", "in_proj"):
            if len(shape) == 3:                       # experts (E, D, F)
                if self._div(shape[0], ts):
                    out[0] = tp                        # expert parallel
                elif self._div(shape[2], ts):
                    out[2] = tp                        # intra-expert TP
            elif self._div(shape[1], ts):
                out[1] = tp
        elif leaf in ("wo", "w2", "out_proj", "x_proj"):
            if len(shape) == 3:                       # experts (E, F, D)
                if self._div(shape[0], ts):
                    out[0] = tp
                elif self._div(shape[1], ts):
                    out[1] = tp
            elif self._div(shape[0], ts):
                out[0] = tp
        elif leaf in ("bq", "bk", "bv"):
            if self._div(shape[0], ts):
                out[0] = tp
        elif leaf in ("dt_proj",):                    # (r, di)
            if self._div(shape[1], ts):
                out[1] = tp
        elif leaf in ("A_log",):                      # (di, n)
            if self._div(shape[0], ts):
                out[0] = tp
        elif leaf in ("conv_w",):                     # (K, di)
            if self._div(shape[1], ts):
                out[1] = tp
        elif leaf in ("conv_b", "dt_bias", "D"):      # (di,)
            if self._div(shape[0], ts):
                out[0] = tp
        # router, norms, scalars: replicated

        if self.fsdp and len(shape) >= 2:
            out = self._add_fsdp(out, shape)
        return spec(*out)

    def _add_fsdp(self, out: list, shape: Tuple[int, ...]) -> list:
        """Shard the largest not-yet-sharded axis over the dp axes."""
        ds = self.dp_size
        order = sorted(range(len(shape)), key=lambda i: -shape[i])
        for i in order:
            if out[i] is None and self._div(shape[i], ds):
                out[i] = self.dp_axes
                break
        return out

    def params_specs(self, cfg: ModelConfig, params) -> dict:
        """The spec of every leaf of the reference's tree for the port's
        parameters `params` (a model): a dict of reference paths
        ("blocks/attn/wq") to specs, at the stacked (L, ...) shapes; the
        counterpart of the reference's ``params_shardings``."""
        shapes: dict = {}
        for name, p in named_leaves(params):
            path, layer = reference_path(name)
            shape = tuple(p.shape)
            if layer is not None:
                shape = (shapes.get(path, (0,))[0] + 1,) + shape
            shapes[path] = shape
        return {path: self.param_spec(path, shape, cfg)
                for path, shape in shapes.items()}

    def cache_specs(self, cfg: ModelConfig, cache,
                    kv_seq_axis: bool = False):
        """Decode-cache specs in the cache's own structure (a list of run
        dicts, or an encoder-decoder's one dict): batch over dp; KV-heads
        or sequence over tp per cfg.kv_cache_shard ('sequence' =
        flash-decoding style)."""
        seq_mode = cfg.kv_cache_shard == "sequence" or kv_seq_axis

        def batch_axes(dim: int):
            """dp sharding for the batch axis only when it divides."""
            return self.dp_axes if self._div(dim, self.dp_size) else None

        def visit(keys: str, shape):
            last = keys.rsplit("/", 1)[-1]
            if last in ("k", "v"):
                # (L, B, Hkv, cap, hd)
                out = [None, batch_axes(shape[1]), None, None, None]
                if seq_mode and self._div(shape[3], self.tp_size):
                    out[3] = self.tp_axis
                elif self._div(shape[2], self.tp_size):
                    out[2] = self.tp_axis
                return spec(*out)
            if "ssm_h" in keys:  # (L, B, di, n)
                out = [None, batch_axes(shape[1]), None, None]
                if self._div(shape[2], self.tp_size):
                    out[2] = self.tp_axis
                return spec(*out)
            if "conv" in keys:   # (L, B, K-1, di)
                out = [None, batch_axes(shape[1]), None, None]
                if self._div(shape[3], self.tp_size):
                    out[3] = self.tp_axis
                return spec(*out)
            if "enc_out" in keys:  # (B, S, D)
                return spec(batch_axes(shape[0]), None, None)
            return spec()

        def walk(node, prefix):
            if isinstance(node, dict):
                return {k: walk(v, prefix + (str(k),))
                        for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return [walk(v, prefix + (str(i),))
                        for i, v in enumerate(node)]
            return visit("/".join(prefix), tuple(node.shape))
        return walk(cache, ())


def make_policy(cfg: ModelConfig, mesh) -> ShardingPolicy:
    names = mesh.axis_names
    dp = tuple(a for a in names if a in ("pod", "data"))
    return ShardingPolicy(
        mesh=mesh,
        dp_axes=dp or (names[0],),
        tp_axis="model" if "model" in names else names[-1],
        fsdp=cfg.param_sharding == "fsdp_tp",
        seq_shard=cfg.seq_shard_activations,
    )


def axes_of(spec: Spec) -> Tuple[str, ...]:
    """The axis names a spec shards over."""
    out = []
    for entry in spec:
        if entry is None:
            continue
        out.extend(entry if isinstance(entry, tuple) else (entry,))
    return tuple(out)


__all__ = ["ShardingPolicy", "make_policy", "axes_of", "spec"]
