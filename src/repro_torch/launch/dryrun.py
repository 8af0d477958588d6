"""Dry run of the distribution plan (counterpart of
``repro.launch.dryrun``): for every arch x shape x {single, multi} cell,
the per-device bytes that the reference's sharding plan gives on its
production mesh, with nothing allocated.

Each cell builds its stand-ins on the ``meta`` device — params
(``model_zoo.init_params(..., device="meta")``), ``param_specs``,
``input_specs`` and, for decode, ``cache_specs`` — takes the reference's
rule choice (``FSDP_RULES`` for the MoE giants, ``RULES`` otherwise;
ZeRO-1 moments for train; caches by ``cache_shardings``; the decode
token over the data axes when they divide the batch) on the abstract
(16, 16) or (2, 16, 16) mesh (``launch/mesh.make_production_mesh``), and
records per-device bytes of the params, the optimizer state (train), the
batch and the caches (decode).

Left out: the reference also jits and compiles each step with XLA and
records ``cost_analysis`` flops and bytes, the collective and convert
bytes scanned from the optimized HLO, ``memory_analysis`` temporaries and
the lower/compile times.  Those are XLA's outputs and PyTorch has no
counterpart that runs without the 256 or 512 devices (ROADMAP §C); the
bytes recorded here are the arguments' share, what the plan itself
decides.

Results go to ``experiments_torch/dryrun/<arch>__<shape>__<mesh>.json``
at the root of the checkout (listed in ``.gitignore``), a summary line
per cell is printed, and existing JSONs are kept unless ``--force``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun               # all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
      --shape train_4k --mesh single --force
"""
from __future__ import annotations

import argparse
import json
import math
import os
from typing import Dict

import torch

from repro_torch.configs import SHAPES, cell_is_supported, get_config, \
    list_archs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model_zoo as zoo
from repro_torch.parallel import sharding as shd

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "..", "..", "experiments_torch", "dryrun")


def shard_shape(shape, spec, mesh):
    """The local shape a pspec gives every device (uneven dims rounded
    up, as XLA pads them)."""
    sizes = shd.axis_sizes(mesh)
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) -
                                                       len(spec))):
        n = 1
        for a in (() if ax is None else ax if isinstance(ax, tuple)
                  else (ax,)):
            n *= sizes[a]
        out.append(math.ceil(dim / n))
    return tuple(out)


def device_bytes(tree, specs, mesh) -> int:
    """Per-device bytes of a tree of meta tensors under a tree of pspecs
    (or one pspec for every leaf)."""
    if isinstance(tree, dict):
        return sum(device_bytes(v, specs[k] if isinstance(specs, dict)
                                else specs, mesh)
                   for k, v in tree.items())
    return math.prod(shard_shape(tuple(tree.shape), specs, mesh)) * \
        tree.element_size()


def _moments(params):
    if isinstance(params, dict):
        return {k: _moments(v) for k, v in params.items()}
    return torch.empty(params.shape, dtype=torch.float32, device="meta")


def plan_cell(cfg, shape, mesh) -> Dict[str, int]:
    """Per-device bytes of each argument class for one cell."""
    params = zoo.init_params(cfg, 0, device="meta")
    specs = zoo.param_specs(cfg)
    rules = shd.FSDP_RULES if cfg.moe is not None else None
    out = {"params": device_bytes(
        params, shd.param_shardings(specs, mesh, params, rules), mesh)}
    inputs = zoo.input_specs(cfg, shape)
    if shape.kind in ("train", "prefill"):
        out["batch"] = sum(device_bytes(v, shd.batch_pspec(mesh, v), mesh)
                           for v in inputs.values())
        if shape.kind == "train":
            moments = shd.zero1_shardings(specs, mesh, params, rules)
            # AdamState: the step (replicated) and two float32 moments
            out["opt_state"] = 4 + 2 * device_bytes(_moments(params),
                                                    moments, mesh)
        return out
    state = zoo.cache_specs(cfg, shape)
    out["caches"] = device_bytes(
        state, shd.cache_shardings(state, mesh, shape.global_batch), mesh)
    daxes = shd.data_axes(mesh)
    tok = inputs["token"]
    tok_spec = (shd.batch_pspec(mesh, tok)
                if shape.global_batch % shd.axis_sizes(mesh)[daxes[0]] == 0
                else shd.replicated(mesh))
    out["batch"] = device_bytes(tok, tok_spec, mesh) + \
        inputs["index"].element_size()
    return out


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             force: bool = False, out_dir: str = OUT_DIR) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_kind}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_is_supported(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    if not ok:
        rec.update(status="skipped", reason=why)
    else:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
        per_device = plan_cell(cfg, shape, mesh)
        rec.update(status="ok", devices=mesh.size,
                   bytes_per_device=per_device,
                   total_bytes_per_device=sum(per_device.values()))
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None, choices=(None, "single", "multi"))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else list(list_archs())
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [args.mesh] if args.mesh else ["single", "multi"]
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                rec = run_cell(arch, shape, mesh_kind, args.force,
                               args.out_dir)
                total = rec.get("total_bytes_per_device")
                print(f"{arch:24s} {shape:12s} {mesh_kind:6s} "
                      f"{rec['status']:7s} per-device="
                      f"{f'{total / 2**30:.3f} GiB' if total else '-'}",
                      flush=True)


if __name__ == "__main__":
    main()
