#!/usr/bin/env python
"""Place-recognition evaluation OFF the training distribution.

The r4 verdict: the shipped vocabulary was trained on the same synthetic
world it was evaluated on, and its candidate precision on the flagship run
was ~0 (90 Sim3 batches, all false). This script measures what the
reference community measures for DBoW2 (recall/precision of place
retrieval, per-sequence):

  * trains (or loads) the shipped vocabulary — training worlds are render
    seeds 100..102 (examples/train_vocab.py);
  * evaluates on HELD-OUT worlds (seeds the vocabulary never saw): a
    normal world, and a deliberately SELF-ALIASED world (periodic wall
    texture, tex_scale < 1) where naive retrieval fires false positives;
  * each eval world runs a 2-lap closed trajectory, so every frame in lap 2
    has exactly one true revisit in lap 1; retrieval ground truth comes
    from the analytic camera poses (within 1.2 m and < 35 deg view-angle);
  * sweeps the detection threshold and reports recall@1, precision at the
    operating threshold, and the score-margin distribution.

Writes artifacts/vocab_eval.json. Run on CPU (renders dominate):

  python examples/eval_vocab.py [--words 32768] [--frames 160]
"""
import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def render_lapped_sequence(seed, frames, laps=2, tex_scale=1.0, duration=64.0):
    """Returns (hists (F,W) unnormalized desc sets, poses [(C_w, R_wc)])."""
    from mc_slam.camera import euroc_camera
    from mc_slam.sim import MavTrajectory, RoomWorld
    cam = euroc_camera()
    world = RoomWorld(np.random.default_rng(seed), tex_size=1024,
                      tex_scale=tex_scale)
    traj = MavTrajectory(duration=duration / laps, seed_phase=seed * 0.31)
    out = []
    for i in range(frames):
        t = i * duration / frames
        P, R = traj.pose(t)
        img = world.render(cam, R, P)
        out.append((img, P, R))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=160)
    ap.add_argument("--laps", type=int, default=2)
    ap.add_argument("--n-feat", type=int, default=1024)
    ap.add_argument("--out", default="")
    ap.add_argument("--platform", default="cpu", choices=["cpu", "gpu"],
                    help="cpu (default) or gpu (fails when JAX finds no GPU)")
    args = ap.parse_args()

    import jax
    from mc_slam import runtime
    if args.platform == "gpu":
        runtime.use_gpu()
        runtime.setup_compile_cache()
    else:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from mc_slam.frontend import bow, extractor

    vocab = bow.load_default_vocab()
    idf = bow.load_default_idf()
    print(f"# vocab: {vocab.shape[0]} words, idf "
          f"{'loaded' if idf is not None else 'absent'}", file=sys.stderr)

    results = {"device": runtime.device_info(jax.devices()),
               "worlds": {}, "vocab_words": int(vocab.shape[0]),
               "train_seeds": [100, 101, 102]}
    # seeds 100-102 are the TRAINING worlds (train_vocab.py); 207/213 are
    # held out; 213 additionally runs with a periodic (self-aliased) texture
    for name, seed, tex_scale in (("train_dist", 100, 1.0),
                                  ("heldout", 207, 1.0),
                                  ("heldout2", 213, 1.0),
                                  ("aliased", 213, 0.22)):
        seq = render_lapped_sequence(seed, args.frames, laps=args.laps,
                                     tex_scale=tex_scale)
        hists = []
        poses = []
        for img, P, R in seq:
            f = extractor.extract(jnp.asarray(img, jnp.float32),
                                  n_features=args.n_feat, n_levels=8)
            h = bow.bow_histogram(f.desc_pm1,
                                  f.valid.astype(jnp.float32), vocab, idf=idf)
            hists.append(np.asarray(h))
            poses.append((P, R))
        H = np.stack(hists)                       # (F, W)
        S = H @ H.T                               # all-pairs scores
        F = len(seq)
        C = np.stack([p for p, _ in poses])
        Rm = np.stack([r for _, r in poses])
        # ground truth: same place = within 1.2 m and < 35 deg viewing angle
        d = np.linalg.norm(C[:, None] - C[None, :], axis=-1)
        # camera forward = R_wc @ [0,0,1]
        fwd = Rm[:, :, 2]
        cosang = np.clip(np.einsum("id,jd->ij", fwd, fwd), -1, 1)
        same_place = (d < 1.2) & (cosang > np.cos(np.deg2rad(35.0)))
        # temporal exclusion: |i-j| >= frames/(2*laps) * 0.5 (out of the
        # local window, like the reference's min-gap rule)
        gap = args.frames // (2 * args.laps)
        far = np.abs(np.arange(F)[:, None] - np.arange(F)[None, :]) >= gap
        cand_mask = far
        Sm = np.where(cand_mask, S, -np.inf)
        top = np.argmax(Sm, axis=1)
        top_score = Sm[np.arange(F), top]
        has_true = (same_place & far).any(axis=1)
        hit = same_place[np.arange(F), top] & far[np.arange(F), top]
        recall1 = float(hit[has_true].mean()) if has_true.any() else -1.0
        # precision/recall vs threshold (the detector's absolute floor)
        sweep = {}
        for th in (0.05, 0.10, 0.15, 0.20, 0.25, 0.30, 0.40):
            fired = top_score >= th
            tp = int((fired & hit).sum())
            fp = int((fired & ~ (same_place[np.arange(F), top])).sum())
            rec = float((fired & hit)[has_true].mean()) if has_true.any() else -1
            sweep[str(th)] = {"tp": tp, "fp": fp,
                              "precision": round(tp / max(tp + fp, 1), 3),
                              "recall": round(rec, 3)}
        results["worlds"][name] = {
            "seed": seed, "tex_scale": tex_scale,
            "frames": F, "n_with_true_revisit": int(has_true.sum()),
            "recall_at_1": round(recall1, 3),
            "median_top_score_true": round(float(
                np.median(top_score[has_true])) if has_true.any() else -1, 3),
            "median_top_score_false": round(float(
                np.median(top_score[~has_true])) if (~has_true).any() else -1,
                3),
            "threshold_sweep": sweep,
        }
        print(f"# {name}: recall@1={recall1:.3f} "
              f"true-med={results['worlds'][name]['median_top_score_true']} "
              f"false-med={results['worlds'][name]['median_top_score_false']}",
              file=sys.stderr)

    out = args.out or os.path.join(os.path.dirname(__file__), "..",
                                   "artifacts", "vocab_eval.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({k: v["recall_at_1"] for k, v in
                      results["worlds"].items()}))
    print(f"wrote {out}", file=sys.stderr)


if __name__ == "__main__":
    main()
