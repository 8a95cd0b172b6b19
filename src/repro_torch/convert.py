"""State carried across from the reference package.

The all-pairs engine has no weights: a run's state is its plan and its
prepared operand.  ``plan_from_reference`` rebuilds the port's plan from a
reference ``ExecutionPlan.spec_dict()`` (a plain dict, as the reference
writes it into its checkpoint sidecars); ``operand_from_reference`` takes
the reference's prepared operand: an array (``np.asarray(plan.prepare(x))``)
or its quantized ``Operand`` of data and per-row scales.  Both packages
then compute the same tiles from the same operand.  On the LM side,
``lm_params_from_reference`` carries a reference model's parameters over.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.allpairs import resolve_device
from repro_torch.core.api import masked_sink_plan
from repro_torch.core.measures import MASKED_NAMES, get_masked
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.quantize import Operand

# spec_dict fields that select modes later slices bring, with the values
# the port runs so far (any replica count: significance plans)
_PORTED = {"tile_kernel": (None, "kendall_merge_tile_kernel",
                           "kendall_tau_b_merge_tile_kernel"),
           "symmetric_grid": (False,),
           "compute_dtype": (None, "bfloat16", "float16", "int8", "int16",
                             "float8_e4m3fn", "float8_e5m2"),
           "p": (1,)}
_WORKLOADS = ("TriangularWorkload", "GridWorkload")
# numpy (ml_dtypes) narrow floats torch.from_numpy refuses: carried over as
# their bit patterns and viewed as the torch type
_VIEWED = {"bfloat16": (np.uint16, torch.bfloat16),
           "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
           "float8_e5m2": (np.uint8, torch.float8_e5m2)}


def plan_from_reference(spec: dict) -> ExecutionPlan:
    """The port's ExecutionPlan for a reference plan's ``spec_dict()``
    (triangular or rectangular grid; float32, bf16, fp16, int8, int16 or fp8
    operands, quantized where the reference quantizes; a merge-sort Kendall
    plan,
    whose tile kernel is named by its ``__name__``; a masked run's sink plan,
    whose measure is a pairwise-complete name such as "pearson_complete";
    a significance plan with its replica count, whose replica_chunk, absent
    from the spec, takes the default).  The reference's permutation indices
    are not state of the plan: a caller carries them over as
    ``PermutationSpec(indices=...)``.

    Raises NotImplementedError for modes the port does not run yet and
    ValueError when the rebuilt plan's spec_dict() differs from `spec`.
    """
    for key, want in _PORTED.items():
        if spec.get(key) not in want:
            raise NotImplementedError(
                f"reference plan has {key}={spec.get(key)!r}; the port runs "
                f"{key} in {want} so far (see ROADMAP queue A)")
    replicas = spec.get("replicas")
    if not isinstance(replicas, int) or replicas < 0:
        raise ValueError(f"replicas must be an int >= 0, got {replicas!r}")
    if spec.get("workload") not in _WORKLOADS:
        raise NotImplementedError(
            f"reference plan has workload={spec.get('workload')!r}; the "
            f"port runs {_WORKLOADS}")
    grid = spec["workload"] == "GridWorkload"
    if not grid and spec["n_rows"] != spec["n_cols"]:
        raise ValueError(f"a triangular spec has n_rows == n_cols, got {spec}")
    masked = spec["measure"] in MASKED_NAMES
    plan = ExecutionPlan.create(
        spec["n_rows"], spec["l"], n_cols=spec["n_cols"] if grid else None,
        t=spec["t"], l_blk=spec["l_blk"],
        measure="dot" if masked else spec["measure"],
        max_tiles_per_pass=spec["max_tiles_per_pass"],
        clip=False if masked else spec["clip"],
        fuse_epilogue=spec["fused"], compute_dtype=spec["compute_dtype"],
        replicas=replicas)
    if masked:
        # a masked run's sink plan: the component plan under the masked
        # measure's identity (core/api._run_masked)
        plan = masked_sink_plan(plan, get_masked(spec["measure"]),
                                spec["clip"])
    if plan.spec_dict() != spec:
        raise ValueError(f"rebuilt plan {plan.spec_dict()} differs from the "
                         f"reference spec {spec}")
    return plan


def operand_from_reference(u_pad, device=None):
    """The reference's prepared (n_pad, l_pad) operand — the row operand,
    or a rectangular plan's column operand v_pad — on `device` (None means
    "cuda"), of the same type: a contiguous float32, float16, int8, int16,
    bfloat16 or fp8 tensor, or, for the reference's quantized ``Operand`` (anything with
    ``data`` and ``scale``), the port's :class:`Operand` of that data and
    its float32 scales.  numpy holds bfloat16 and fp8 as ``ml_dtypes``
    arrays, which ``torch.from_numpy`` refuses, so their bit patterns are
    carried over as uint16 / uint8 and viewed as the torch type."""
    if hasattr(u_pad, "scale") and hasattr(u_pad, "data"):
        scale = np.array(u_pad.scale, dtype=np.float32, order="C")
        data = operand_from_reference(u_pad.data, device)
        if scale.shape != (data.shape[0],):
            raise ValueError(f"scales {scale.shape} do not match the "
                             f"operand's {data.shape[0]} rows")
        return Operand(data, torch.from_numpy(scale).to(data.device))
    u = np.array(u_pad, order="C")
    if u.ndim != 2:
        raise ValueError(f"expected a 2-D operand, got shape {u.shape}")
    if u.dtype in (np.float32, np.float16, np.int8, np.int16):
        t = torch.from_numpy(u)
    elif u.dtype.name in _VIEWED and \
            u.dtype.itemsize == np.dtype(_VIEWED[u.dtype.name][0]).itemsize:
        bits, dtype = _VIEWED[u.dtype.name]
        t = torch.from_numpy(u.view(bits)).view(dtype)
    else:
        raise ValueError(f"expected a float32, float16, bfloat16, int8, "
                         f"int16 or fp8 operand, got {u.dtype}")
    return t.to(resolve_device(device))


def lm_params_from_reference(cfg, params, device=None,
                             trainable: bool = False, mesh=None):
    """The port's parameters (a ``models.transformer.DecoderLM``, or a
    ``models.encdec.EncDecLM`` for an encoder-decoder config, on `device`,
    None meaning "cuda") for the reference's parameter pytree of the same
    config: nested dicts of float32 arrays, the layers' leaves stacked
    (L, ...) under ``blocks`` (and ``enc_blocks``, stacked ``enc_layers``),
    as ``np.asarray`` of each leaf of ``model.init(key)`` gives them.
    Raises ValueError when a leaf is missing, left over, of another shape,
    or not float32.  ``trainable`` leaves require grad (training); serving
    holds frozen ones.  With a (data, model) ``mesh`` (in place of
    `device`) each leaf is cut into the ranks' shards as
    ``sharding.make_policy(cfg, mesh)`` places them: a
    ``models.parallel.ShardedLM``."""
    # the LM side loads on demand
    from repro_torch.models.encdec import EncDecLM
    from repro_torch.models.registry import build_model
    from repro_torch.models.transformer import DecoderLM

    want = dict(build_model(cfg).init_shapes().named_parameters())
    depth = {"blocks": cfg.n_layers, "enc_blocks": cfg.enc_layers}
    flat = {}

    def walk(node, path):
        if isinstance(node, dict):
            for key, sub in node.items():
                walk(sub, path + (str(key),))
        else:
            flat["/".join(path)] = np.asarray(node)
    walk(params, ())
    place = None
    if mesh is not None:
        from repro_torch.models.parallel import Placement
        from repro_torch.models.sharding import make_policy
        place = Placement(cfg, make_policy(cfg, mesh))
    dev = resolve_device(device) if place is None else torch.device("cpu")
    tensors = {name: [{} for _ in range(n)] for name, n in depth.items()}
    expected = set()
    for name, shape_like in want.items():
        shape = tuple(shape_like.shape)
        parts = name.split(".")
        stack = parts[0] in depth   # <stack>.<i>.<sub>[.<leaf>]
        if stack:
            if parts[1] != "0":
                continue
            key, shape = "/".join([parts[0]] + parts[2:]), \
                (depth[parts[0]],) + shape
        else:
            key = name
        expected.add(key)
        if key not in flat:
            raise ValueError(f"the reference parameters lack {key}")
        arr = flat[key]
        if arr.shape != shape or arr.dtype != np.float32:
            raise ValueError(f"{key}: expected float32 {shape}, got "
                             f"{arr.dtype} {arr.shape}")
        t = torch.from_numpy(np.array(arr, order="C")).to(dev)
        if not stack:
            tensors[key] = t
            continue
        for i, node in enumerate(tensors[parts[0]]):
            for part in parts[2:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = t[i]
    extra = sorted(set(flat) - expected)
    if extra:
        raise ValueError(f"reference parameters the port does not have: "
                         f"{extra}")
    cls = EncDecLM if cfg.enc_dec else DecoderLM
    if place is None:
        return cls(cfg, tensors, trainable)
    placed = {name: ([place(name, t) for t in tree]
                     if name in depth else place(name, tree))
              for name, tree in tensors.items()}
    return place.build(cls, cfg, placed, trainable)


__all__ = ["plan_from_reference", "operand_from_reference",
           "lm_params_from_reference"]
