"""The paths that launch K5 and K8, timed on the card, in this checkout or
in another one, in turns.

    python vda_tpu_torch/probes/time_short_attn_paths.py [--tree DIR]
    python vda_tpu_torch/probes/time_short_attn_paths.py --against DIR
        [--turns 2]

Four paths, each on seeded random weights: one vits 1x32x518x518 bf16
window ``forward`` (K5 in three of its motion modules, 6 launches; CUDA
events, mean of 3), the first ``StreamingDepth.submit`` of a vitl stream
(K5 at T = 1, 8 launches; host clock around the call and a synchronize, a
fresh stream each time, median of 5), ``block_apply_nested`` on vitl's
first encoder block over DINOv2's multi-crop batch (K8, one launch; CUDA
events, mean of 10) and one vitg 1x32x518x518 bf16 window ``forward``
(``load_model_params("vitg", random_init=True)``, cast once; K5 at head
width 192 in mm0/mm1, 4 launches; CUDA events, mean of 3).  ``--tree DIR`` imports ``vda_tpu_torch`` from DIR (a
checkout unpacked by ``git archive``, which builds its own kernels into its
own ``csrc/build``), so the same code times both sides; ``--against DIR``
runs this file in a process per side in the order other, this, this,
other (``--turns`` such pairs) and prints each side's numbers and their
medians.  Prints one JSON line a run; fails without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
SIZE = 518
MULTI_CROP = (32, (2, 257), (8, 50))  # images, (crops, tokens) global, local


def measure(tree: str) -> dict:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import vda_tpu_torch as vt
    from vda_tpu_torch.models.dinov2 import block_apply_nested
    from vda_tpu_torch.utils.transform import preprocess_frames

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        sys.exit(1)

    def events_ms(fn, reps):
        fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    frames = (np.random.default_rng(0).random((32, SIZE, SIZE, 3))
              * 255).astype(np.uint8)
    out = {"tree": tree, "device": torch.cuda.get_device_name(0)}
    with torch.no_grad():
        vits = vt.init_random(vt.get_config("vits"),
                              torch.Generator(device="cuda").manual_seed(0))
        vits.requires_grad_(False)
        x = preprocess_frames(torch.from_numpy(frames[None]).cuda(),
                              (SIZE, SIZE), dtype=torch.bfloat16)
        out["vits_window_ms"] = events_ms(lambda: vt.forward(vits, x), 3)
        del vits, x
        vitl = vt.init_random(vt.get_config("vitl"),
                              torch.Generator(device="cuda").manual_seed(0))
        vitl.requires_grad_(False)
        firsts = []
        for i in range(6):  # the first a warm-up
            stream = vt.StreamingDepth(vitl)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stream.submit(frames[i])
            torch.cuda.synchronize()
            firsts.append(1e3 * (time.perf_counter() - t0))
            del stream
        out["stream_first_step_ms"] = float(np.median(firsts[1:]))
        cfg = vitl.cfg.vit
        g = torch.Generator(device="cuda").manual_seed(4)
        n_img, (n_g, len_g), (n_l, len_l) = MULTI_CROP
        x_list = [torch.randn(n_img * k, n, cfg.embed_dim, device="cuda",
                              generator=g).to(torch.bfloat16)
                  for k, n in ((n_g, len_g), (n_l, len_l))]
        blk = vitl.pretrained.blocks[0]
        out["nested_block_ms"] = events_ms(
            lambda: block_apply_nested(blk, x_list, cfg), 10)
        del vitl, blk, x_list
        _, vitg = vt.load_model_params("vitg", random_init=True)
        vitg.requires_grad_(False)
        x = preprocess_frames(torch.from_numpy(frames[None]).cuda(),
                              (SIZE, SIZE), dtype=torch.bfloat16)
        out["vitg_window_ms"] = events_ms(lambda: vt.forward(vitg, x), 3)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=HERE,
                    help="the checkout whose vda_tpu_torch is timed")
    ap.add_argument("--against", metavar="DIR",
                    help="time DIR and this checkout in turns")
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args(argv)
    if not args.against:
        print(json.dumps(measure(os.path.abspath(args.tree))), flush=True)
        return 0
    other = os.path.abspath(args.against)
    runs = {other: [], HERE: []}
    for _ in range(args.turns):
        for tree in (other, HERE, HERE, other):
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--tree", tree], capture_output=True,
                               text=True, cwd=tree)
            if r.returncode:
                sys.stderr.write(r.stderr[-4000:])
                return r.returncode
            line = json.loads(r.stdout.strip().splitlines()[-1])
            runs[tree].append(line)
            print(json.dumps(line), flush=True)
    import statistics

    for tree, lines in runs.items():
        print(json.dumps({"tree": tree, "median": {
            k: statistics.median(ln[k] for ln in lines)
            for k in ("vits_window_ms", "stream_first_step_ms",
                      "nested_block_ms", "vitg_window_ms")}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
