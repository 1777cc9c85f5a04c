"""Peak device memory of one image-mode WeightPredictor train step of the
PyTorch/CUDA port, on one card.

    python3 scripts/torch_step_memory.py

Batch 4 at the 384x512 LR bucket (four flips of a seeded 339x510 frame,
HR 1536x2048, f32), as ``chip_smoke.train_wp_image`` runs it. Each variant
takes one step from the same parameters and prints one JSON line: its peak
(``torch.cuda.max_memory_allocated`` over a warm step), its loss, and for
all but ``plain`` the loss's equality with the plain step's and the
parameters' largest difference from them. The variants are the step as
``train/trainer.py`` makes it (``plain``, ``remat``: the three checkpointed
segments of ``models/weight_predictor.forward_params``) and three earlier
designs rebuilt here: the plain step whose MAE keeps its graph through the
backward, the whole forward in one checkpoint, and three segments whose
head took the two 16-channel maps and concatenated them itself. For the
plain step the caching allocator's trace is replayed and the blocks alive
at its peak are listed by the frames that allocated them.
"""

import collections
import json
import pathlib
import sys

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from bicubic_interpolation_model_tpu_torch.models import weight_predictor as wpm  # noqa: E402
from bicubic_interpolation_model_tpu_torch.train import trainer as tr  # noqa: E402


def _ck(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False)


def _head_concatenating(p, gated, off):
    return wpm._head(p, torch.cat([gated, off], dim=-1))


def _first_segments(params, img, off):
    p = params["params"]
    return _ck(_head_concatenating, p, _ck(wpm._gated_features, p, img),
               _ck(wpm._offset_features, p, off))


def _step_keeping_mae_graph(forward, dev):
    def step(params, opt_state, img, off, y, mask):
        img, off, y, mask = (tr.on_device(a, dev) for a in (img, off, y, mask))
        with tr.full_f32():
            opt_state.zero_grad()
            loss, mae = tr.masked_losses(forward(params, img, off), y, mask)
            loss.backward()
            opt_state.step()
        return params, opt_state, loss.detach(), mae.detach()
    return step


def _frames(ev):
    out, cpp = [], None
    for f in ev.get("frames", []):
        fn, name = f.get("filename", ""), f.get("name", "")
        if fn.endswith(".py"):
            if "bicubic_interpolation_model_tpu_torch" in fn:
                out.append(f"{fn.split('/')[-1]}:{f.get('line')} {name}")
        elif cpp is None and ("Backward" in name or "cudnn" in name
                              or "native::" in name):
            cpp = name[:70]
    return ([cpp] if cpp else []) + out[:2]


def _blocks_at_peak(snap):
    live, cur, best, best_live = {}, 0, 0, {}
    for ev in snap["device_traces"][0]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
            cur += ev["size"]
        elif ev["action"] == "free_requested" and ev["addr"] in live:
            cur -= live.pop(ev["addr"])["size"]
        if cur > best:
            best, best_live = cur, dict(live)
    groups = collections.Counter()
    for ev in best_live.values():
        groups[" | ".join(_frames(ev)) or "?"] += ev["size"]
    return groups.most_common(8)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_step_memory: no CUDA device visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    x = np.random.default_rng(0).random((339, 510, 4), np.float32)
    data = {f"f{i}": {"X": np.ascontiguousarray(f)} for i, f in
            enumerate((x, x[::-1], x[:, ::-1], x[::-1, ::-1]))}
    wp = wpm.WeightPredictor()
    params = tr.fresh_params(wpm.WeightPredictor(), dev, 0)
    t = tr.WeightPredictorTrainer(wp, tr.TrainConfig(mode="image",
                                                     image_batch=4),
                                  device=dev)
    batch = next(t._image_batches(data))
    variants = {
        "plain": tr.make_weight_predictor_step(wp),
        "remat": tr.make_weight_predictor_step(wp, remat=True),
        "plain_mae_graph_kept": _step_keeping_mae_graph(wp.apply, dev),
        "remat_whole_forward_mae_kept": _step_keeping_mae_graph(
            lambda p, i, o: _ck(wp.apply, p, i, o), dev),
        "remat_head_concatenating_mae_kept": _step_keeping_mae_graph(
            _first_segments, dev),
    }
    plain = None
    for label, step in variants.items():
        p = tr.trainable(params, dev)
        opt = t.optimizer.init(p)
        loss = float(step(p, opt, *batch)[2])
        after = [q.detach().clone() for q in tr.leaves(p)]
        step(p, opt, *batch)                     # warm
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if label == "plain":
            torch.cuda.memory._record_memory_history(max_entries=100000,
                                                     stacks="all")
        step(p, opt, *batch)
        torch.cuda.synchronize()
        line = {"variant": label,
                "peak_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
                "loss": loss}
        if plain is None:
            plain = (loss, after)
        else:
            line["loss_equal_plain"] = loss == plain[0]
            line["params_max_abs_vs_plain"] = max(
                float((a - b).abs().max()) for a, b in zip(after, plain[1]))
        print(json.dumps(line), flush=True)
        if label == "plain":
            snap = torch.cuda.memory._snapshot()
            torch.cuda.memory._record_memory_history(enabled=None)
            for frames, size in _blocks_at_peak(snap):
                print(f"  {size / 2 ** 20:9.1f} MB  {frames}", flush=True)
        del p, opt, after
    return 0


if __name__ == "__main__":
    sys.exit(main())
