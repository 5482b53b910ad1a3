"""Multi-pod dry-run: the counterpart of the JAX package's
``launch/dryrun.py``.

For every (architecture x input shape x mesh) cell, one step (a train step:
loss, gradient and AdamW; a prefill; or one decode step over a cache of
``seq_len`` positions) runs on ``meta`` DTensors laid out by the spec trees
on a fake process group of 256 (16x16) or 512 (2x16x16) ranks: shapes and
placements, no data, no card. ``hlo_analysis.CostMode`` counts what one
rank does: FLOPs, HBM traffic, collective bytes by kind and the peak of
live bytes. The persistent bytes per rank (params, optimizer state, inputs
or cache) come from the spec trees. Each record has the memory per rank
against the H100's 80 GB and a roofline time per term on the H100's
constants. Records are JSON under ``artifacts/dryrun_torch/``.

A 2x16x16 cell is traced on a 32x16 mesh (``trace_mesh``), its persistent
bytes counted on 2x16x16. The models run Python loops, so a cell is
traced at a few small depths (``trace_plan``) whose linear combination
gives every count at the full depth. On meta tensors every kernel wrapper
takes its plain version, run on each rank's shards
(``distributed.shard_kernels.per_shard``) and counted as the kernel; so the
attention FLOPs are those of the plain version's full S x S product (the
kernels skip a causal mask's masked half), and in training also its
backward's recompute of the forward and of the LSE.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
      --shape train_4k --mesh multi
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import SHAPE_BY_NAME, SHAPES, InputShape, ModelConfig, \
    cell_is_runnable
from repro_torch.configs.hardware import H100
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
from repro_torch.distributed import shard_kernels
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.hlo_analysis import Cost, analyse, combine
from repro_torch.models import api as mapi
from repro_torch.models import common as cm
from repro_torch.train import optimizer as opt
from repro_torch.train import steps

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")


def slstm_seqs() -> Tuple[int, int]:
    """The sLSTM layer's own trace lengths (its counts are linear in S): two
    multiples of the model axis (16 on the production meshes), so that its
    sequence dims split as the cell's do."""
    m = max(4, sh.axis_size("model"))
    return m, 2 * m


# Sites that run on full replicas under a mesh (``sh.replicated``: no DTensor
# rule), by family. Their buffers sit whole on every rank, so a cell's
# activation peak, and its ``fits``, are an upper bound that a sharded form
# of the site would lower; the MoE dispatch holds every token of the global
# batch and the (E * cap + 1, d) expert buffers.
REPLICATED_SITES = {
    "moe": "models/mlp.py moe_forward_onehot: dispatch, combine and aux scatter",
    "ssm": "models/xlstm.py: the forget gates' logsigmoid",
}


def _meta(rec) -> torch.Tensor:
    return torch.empty(rec.shape, dtype=rec.dtype, device="meta")


def local_bytes(shape, dtype, spec, axes: Dict[str, int]) -> int:
    """Bytes of one rank's shard of a tensor laid out by ``spec`` on a mesh
    of these {axis: size}."""
    n = math.prod(shape)
    for entry in sh.sanitize_spec(spec, shape, axes):
        for a in sh._flatten_spec_axes(entry):
            n //= axes[a]
    return n * torch.empty((), dtype=dtype).element_size()


def _tree_bytes(records: Dict, specs: Dict, axes: Dict[str, int]) -> int:
    return sum(local_bytes(r.shape, r.dtype, specs[k], axes) for k, r in records.items())


@dataclass
class Step:
    """One cell's step, ready to trace: ``fn()`` runs it, each kernel's plain
    version on each rank's shards (``shard_kernels.per_shard``); ``memory``
    has the persistent bytes per rank by part on the installed mesh."""
    run: Callable[[], object]
    memory: Dict[str, int]

    def fn(self):
        with shard_kernels.per_shard():
            return self.run()

    @property
    def persistent(self) -> int:
        return sum(self.memory.values())


def build_step(cfg: ModelConfig, shape: InputShape) -> Step:
    """The step of one cell on meta DTensors on the installed mesh:
    ``train`` is the loss's forward and backward (remat as the config says)
    plus the AdamW update; ``prefill`` the model's prefill; ``decode`` one
    decode step over a cache of ``seq_len`` positions."""
    model = mapi.get_model(cfg)
    precs, pspecs = mapi.param_records(cfg), mapi.param_specs(cfg)
    params = cm.nest(sh.distribute({k: _meta(r) for k, r in precs.items()}, pspecs))
    memory = persistent_bytes(cfg, shape, sh.mesh_axes(sh.current_mesh()))
    inputs, ispecs = mapi.input_specs(cfg, shape)
    if shape.kind == "decode":
        cache = sh.distribute({k: _meta(r) for k, r in inputs["cache"].items()},
                              ispecs["cache"])
        tokens = sh.distribute({"t": _meta(inputs["tokens"])}, {"t": ispecs["tokens"]})["t"]

        def fn():
            with torch.no_grad():
                return model.decode_step(params, cfg, cache, tokens)
        return Step(fn, memory)
    batch = sh.distribute({k: _meta(r) for k, r in inputs.items()}, ispecs)
    if shape.kind == "prefill":
        def fn():
            with torch.no_grad():
                return model.prefill(params, cfg, batch)
        return Step(fn, memory)
    orecs = _opt_records(precs)
    opt_state = cm.nest(sh.distribute({k: _meta(r) for k, r in orecs.items()},
                                      opt.opt_state_specs(pspecs)))
    train_step = steps.make_train_step(cfg, opt.OptConfig())
    return Step(lambda: train_step(params, opt_state, batch), memory)


def _opt_records(precs):
    out = {f"{n}/{k}": mapi.ShapeDtype(r.shape, torch.float32)
           for n in ("m", "v") for k, r in precs.items()}
    out["step"] = mapi.ShapeDtype((), torch.int32)
    return out


def persistent_bytes(cfg: ModelConfig, shape: InputShape, axes: Dict[str, int]) -> Dict[str, int]:
    """The bytes per rank that live through the step, by part (params;
    optimizer state; the batch, or the cache and the tokens), from the
    records and the specs on a mesh of these {axis: size}."""
    precs, pspecs = mapi.param_records(cfg), mapi.param_specs(cfg)
    memory = {"params": _tree_bytes(precs, pspecs, axes)}
    inputs, ispecs = mapi.input_specs(cfg, shape)
    if shape.kind == "decode":
        memory["cache"] = _tree_bytes(inputs["cache"], ispecs["cache"], axes) \
            + local_bytes(inputs["tokens"].shape, inputs["tokens"].dtype, ispecs["tokens"], axes)
        return memory
    memory["inputs"] = _tree_bytes(inputs, ispecs, axes)
    if shape.kind == "train":
        memory["optimizer"] = _tree_bytes(_opt_records(precs), opt.opt_state_specs(pspecs), axes)
    return memory


def trace_plan(cfg: ModelConfig, shape: InputShape) -> List[Tuple[float, ModelConfig,
                                                                 InputShape]]:
    """[(coef, cfg_i, shape_i)]: small-depth traces whose sum weighted by
    coef gives the cell's counts. Every count of a step is linear in the
    number of layers of each kind (dense/MoE/VLM: layers; hybrid: Mamba
    layers and shared-block insertions; xLSTM: mLSTM and sLSTM layers), so
    traces at 1-2 layers of each kind give it at any depth (Whisper is
    traced whole). The sLSTM layer of a long xLSTM train or prefill step
    (a Python loop of S cell steps) is traced at two short lengths, its
    counts being linear in S; the rest at S. The peak of live bytes is
    combined the same way, as the peaks of small depths extrapolated."""
    f = cfg.family
    if f in ("dense", "moe", "vlm"):
        L = cfg.n_layers
        plan = [(2 - L, cfg.with_(n_layers=1)), (L - 1, cfg.with_(n_layers=2))]
    elif f == "audio":
        # every decoder layer adds to the gradient of the one encoder output,
        # and DTensor lays the running sum out anew as it grows: the counts
        # are not linear in the depth, so the whole model is traced (6 + 6
        # layers for whisper-base)
        plan = [(1, cfg)]
    elif f == "hybrid":
        L, I = cfg.n_layers, cfg.n_layers // cfg.attn_every
        # base + m + s, base + 2m + 2s, base + 2m + s (each trace runs the
        # shared block, so that every param gets a gradient)
        plan = [(2 - L, cfg.with_(n_layers=1, attn_every=1)),
                (I - 1, cfg.with_(n_layers=2, attn_every=1)),
                (L - I, cfg.with_(n_layers=2, attn_every=2))]
    elif f == "ssm":
        Ls = cfg.n_layers // cfg.slstm_every if cfg.slstm_every else 0
        Lm = cfg.n_layers - Ls
        A, B = cfg.with_(n_layers=1, slstm_every=0), cfg.with_(n_layers=2, slstm_every=0)
        C = cfg.with_(n_layers=2, slstm_every=2)
        S = shape.seq_len
        s1, s2 = slstm_seqs()
        if shape.kind != "decode" and Ls and S > s2:
            # base + Lm m from A and B at S; the sLSTM layer, C - A, at two
            # short lengths (a trace of S tokens would take hours), extended
            # to S along the line through them
            w2 = (S - s1) / (s2 - s1)
            plan = [(2 - Lm, A, shape), (Lm - 1, B, shape)]
            for w, s_ in ((1 - w2, s1), (w2, s2)):
                at = replace(shape, seq_len=s_)
                plan += [(w * Ls, C, at), (-w * Ls, A, at)]
            return [t for t in plan if t[0] != 0]
        # base + m, base + 2m, base + m + s
        plan = [(2 - Lm - Ls, A), (Lm - 1, B), (Ls, C)]
    else:
        raise ValueError(f"no trace plan for family {f!r}")
    return [(c, k, shape) for c, k in plan if c != 0]


def estimate(cfg: ModelConfig, shape: InputShape,
             axes: Optional[Dict[str, int]] = None) -> Tuple[Cost, Dict[str, int]]:
    """(per-rank cost of the cell's step traced on the installed mesh,
    persistent bytes per rank by part on a mesh of ``axes`` (default the
    installed one)). The cost's ``peak_bytes`` is the persistent bytes plus
    the traces' activation peak (their peak above their own persistent
    bytes)."""
    from torch.distributed.tensor.experimental import implicit_replication
    terms = []
    for coef, c, s in trace_plan(cfg, shape):
        step = build_step(c, s)
        with implicit_replication():
            # DTensor plans an op's sharding on its first call, and some of
            # that planning runs ops (an op without a rule is decomposed
            # once): a first, uncounted run keeps them out of the count
            step.fn()
            _, cost = analyse(step.fn, base_bytes=step.persistent)
        cost.peak_bytes -= step.persistent
        cost.segment_peaks = [p - step.persistent for p in cost.segment_peaks]
        terms.append((coef, cost))
    total = combine(terms)
    memory = persistent_bytes(cfg, shape, axes or sh.mesh_axes(sh.current_mesh()))
    # each segment's activation peak is linear in the depth; the step's is
    # the largest (which segment that is can change with the depth)
    total.segment_peaks = [sum(memory.values()) + max(0.0, a) for a in total.segment_peaks]
    total.peak_bytes = max(total.segment_peaks)
    return total, memory


def trace_mesh(dims, axes):
    """The mesh a cell's step is traced on: the cell's own, except that a
    "pod" axis is merged into the "data" axis after it (2x16x16 is traced as
    32x16). DTensor plans a tensor dim split over two mesh dims, as
    ("pod", "data") splits the batch, by a search that takes minutes an op
    and picks gathers no step needs; on the merged axis the batch is split
    32 ways as on the pods. What the reference shards over "data" alone
    (caches, fsdp weights) is then split 32 ways in the traced step too, so
    a cell's persistent bytes are counted on the cell's own mesh, from the
    specs, and only its activations and its traffic come from the trace."""
    if "pod" not in axes:
        return tuple(dims), tuple(axes)
    i = axes.index("pod")
    if axes[i + 1] != "data":
        raise ValueError(f"the pod axis must come just before data: {axes}")
    merged = list(dims[:i]) + [dims[i] * dims[i + 1]] + list(dims[i + 2:])
    return tuple(merged), tuple(a for a in axes if a != "pod")


def _mesh_name(shape) -> str:
    return "x".join(map(str, shape))


def roofline(cost: Cost, hw=H100) -> Dict[str, float]:
    """Seconds per term on the card's constants: FLOPs at the dense bf16
    peak, traffic at the HBM rate, collective bytes at the NVLink rate."""
    return {"compute_s": cost.flops / (hw.tflops * 1e12),
            "memory_s": cost.traffic / (hw.bw_tbps * 1e12),
            "collective_s": cost.collective_total / (hw.intra_node_gbps * 1e9)}


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             out_dir: str = ARTIFACT_DIR, verbose: bool = True,
             shape: Optional[InputShape] = None,
             mesh_shape: Optional[Tuple[Tuple[int, ...], Tuple[str, ...]]] = None,
             smoke: bool = False) -> Dict:
    """Trace one cell on a fake process group and write its JSON record.
    ``shape`` overrides the named input shape, ``mesh_shape`` ((dims),
    (axis names)) the production mesh, ``smoke`` takes the arch's smoke
    config; the record's cell id names the shape and the mesh."""
    cfg = (get_smoke_config if smoke else get_config)(arch)
    shape = shape or SHAPE_BY_NAME[shape_name]
    dims, axes = mesh_shape or (mesh_mod.MULTI_POD if multi_pod else mesh_mod.SINGLE_POD)
    mesh_name = _mesh_name(dims)
    cell_id = f"{arch}__{shape.name}__{mesh_name}"
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, cell_id + ".json")
    base = {"cell": cell_id, "arch": arch, "shape": shape.name, "mesh": mesh_name,
            "global_batch": shape.global_batch, "seq_len": shape.seq_len, "kind": shape.kind}

    ok, why = cell_is_runnable(cfg, shape)
    if not ok:
        rec = dict(base, status="skipped", reason=why)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        if verbose:
            print(f"[dryrun] {cell_id}: SKIPPED ({why})")
        return rec

    t0 = time.time()
    n_dev = math.prod(dims)
    with mesh_mod.process_group(n_dev), \
            sh.use_mesh(mesh_mod.make_mesh(*trace_mesh(dims, axes), device_type="cpu")):
        cost, memory = estimate(cfg, shape, axes=dict(zip(axes, dims)))
    persistent = sum(memory.values())
    total = max(cost.peak_bytes, persistent)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    model_flops = (6 if shape.kind == "train" else 2) * cfg.param_count(active_only=True) \
        * tokens / n_dev
    rec = dict(base, **{
        "status": "ok",
        "n_devices": n_dev,
        "seconds": round(time.time() - t0, 2),
        "params": cfg.param_count(),
        "params_active": cfg.param_count(active_only=True),
        "flops_per_device": cost.flops,
        "model_flops_per_device": model_flops,
        "traffic_bytes_per_device": cost.traffic,
        "collective_bytes": dict(cost.collectives),
        "collective_bytes_total": cost.collective_total,
        "memory": dict(memory, persistent=persistent,
                       activations=total - persistent, total=total,
                       hbm=H100.mem_bytes, fits=bool(total <= H100.mem_bytes),
                       replicated_sites=REPLICATED_SITES.get(cfg.family)),
        "roofline": roofline(cost),
        "hardware": H100.name,
        "trace_plan": [{"coef": c, "n_layers": k.n_layers, "seq_len": s.seq_len,
                        **({"attn_every": k.attn_every} if k.family == "hybrid" else {}),
                        **({"slstm_every": k.slstm_every} if k.family == "ssm" else {}),
                        **({"n_enc_layers": k.n_enc_layers} if k.family == "audio" else {})}
                       for c, k, s in trace_plan(cfg, shape)],
    })
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    if verbose:
        r = rec["roofline"]
        print(f"[dryrun] {cell_id}: OK {rec['seconds']:.1f}s "
              f"TFLOPs/dev={cost.flops / 1e12:.2f} coll={cost.collective_total / 1e9:.2f}GB "
              f"mem={total / 1e9:.2f}GB fits={rec['memory']['fits']} "
              f"roofline ms: compute {r['compute_s'] * 1e3:.2f} memory "
              f"{r['memory_s'] * 1e3:.2f} collective {r['collective_s'] * 1e3:.2f}")
    return rec


def table(out_dir: str = ARTIFACT_DIR) -> str:
    """A markdown table of the records under ``out_dir``: one row per (arch,
    shape), each mesh's memory per rank (and whether it fits), FLOPs and
    collective bytes per device, and roofline ms (compute / memory /
    collective) on the H100's constants, a * on the memory of a cell with
    replicated sites; the skipped cells in one line."""
    import glob
    recs = [json.load(open(f)) for f in sorted(glob.glob(os.path.join(out_dir, "*.json")))]
    rows, skipped = {}, []
    for r in recs:
        if r["status"] != "ok":
            skipped.append(f"{r['arch']} {r['shape']} {r['mesh']}")
            continue
        m, rf = r["memory"], r["roofline"]
        rows.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = (
            f"{m['total'] / 1e9:.2f} {'yes' if m['fits'] else 'NO'}"
            f"{'*' if m.get('replicated_sites') else ''}",
            f"{r['flops_per_device'] / 1e12:.4g}", f"{r['collective_bytes_total'] / 1e9:.4g}",
            f"{rf['compute_s'] * 1e3:.4g} / {rf['memory_s'] * 1e3:.4g} / "
            f"{rf['collective_s'] * 1e3:.4g}")
    meshes = ("16x16", "2x16x16")
    lines = ["| arch | shape | " + " | ".join(
        f"{g} GB/rank, fits | {g} TFLOP/dev | {g} coll GB/dev | {g} roofline ms" for g in meshes)
        + " |", "|" + "---|" * (2 + 4 * len(meshes))]
    order = {a: i for i, a in enumerate(ARCH_IDS)}
    for (arch, shape), cells in sorted(rows.items(), key=lambda kv: (order.get(kv[0][0], 99),
                                                                     kv[0][1])):
        cols = [c for g in meshes for c in cells.get(g, ("-",) * 4)]
        lines.append(f"| {arch} | {shape} | " + " | ".join(cols) + " |")
    lines.append("\n\\* an upper bound: a site of the step runs on full replicas "
                 "(`REPLICATED_SITES`)")
    if skipped:
        lines.append(f"\nSkipped ({len(skipped)}, `cell_is_runnable`): " + "; ".join(skipped))
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--table", action="store_true",
                    help="print a markdown table of the records under --out and stop")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.out))
        return

    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = [s.name for s in SHAPES] if (args.all or args.shape is None) else [args.shape]
    meshes = {"single": [mesh_mod.SINGLE_POD], "multi": [mesh_mod.MULTI_POD],
              "both": [mesh_mod.SINGLE_POD, mesh_mod.MULTI_POD]}[args.mesh]

    failures = []
    t0 = time.time()
    for arch in archs:
        for name in shapes:
            shape = SHAPE_BY_NAME[name]
            for ms in meshes:
                path = os.path.join(args.out, f"{arch}__{shape.name}__{_mesh_name(ms[0])}.json")
                if args.skip_existing and os.path.exists(path):
                    with open(path) as f:
                        if json.load(f).get("status") in ("ok", "skipped"):
                            continue
                try:
                    run_cell(arch, name, out_dir=args.out, shape=shape, mesh_shape=ms)
                except Exception as e:      # noqa: BLE001  (every cell runs; failures exit 1)
                    failures.append((arch, shape.name, _mesh_name(ms[0]), repr(e)[:200]))
                    traceback.print_exc()
                    print(f"[dryrun] {arch}/{shape.name}/{_mesh_name(ms[0])}: FAIL {e!r}")
    print(f"[dryrun] {time.time() - t0:.1f}s")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nall dry-run cells passed")


if __name__ == "__main__":
    main()
