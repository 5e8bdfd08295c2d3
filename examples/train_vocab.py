#!/usr/bin/env python
"""Train and persist the default BoW vocabulary.

The reference ships a ~1M-node DBoW2 tree trained offline
(ORBvoc, TemplatedVocabulary.h:1467). The flat vocabulary
(frontend/bow.py) needs far fewer centroids because assignment is an exact
GEMM + argmax over ALL words rather than an approximate greedy tree descent.
This script harvests ORB descriptors from many rendered viewpoints of
diverse synthetic worlds and k-majority-trains the shipped vocabulary
artifact (mc_slam/assets/vocab.npz).

  python examples/train_vocab.py [--mav0 /tmp/euroc_clone/mav0] --words 4096
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mav0", default="", help="optional ASL folder to harvest from")
    ap.add_argument("--words", type=int, default=32768)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--n-feat", type=int, default=1024)
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from mc_slam.frontend import bow, extractor

    descs = []
    if args.mav0:
        from mc_slam.io import euroc
        seq = euroc.load_sequence(args.mav0)
        paths = list(seq.image_paths)[:: max(1, len(seq.image_paths) // args.frames)]
        for p in paths[:args.frames]:
            img = euroc.load_gray_image(p)
            f = extractor.extract(jnp.asarray(img, jnp.float32),
                                  n_features=args.n_feat, n_levels=8)
            d = np.asarray(f.desc_pm1)[np.asarray(f.valid)]
            descs.append(d)
            print(f"harvested {len(d)} descriptors from {os.path.basename(p)}",
                  file=sys.stderr)
    else:
        # no dataset: harvest from freshly rendered room worlds (diverse seeds)
        from mc_slam.camera import euroc_camera
        from mc_slam.sim import MavTrajectory, RoomWorld
        cam = euroc_camera()
        rng = np.random.default_rng(7)
        for seed in range(3):
            world = RoomWorld(np.random.default_rng(100 + seed), tex_size=1024)
            traj = MavTrajectory(duration=60.0, seed_phase=seed * 1.7)
            for i in range(args.frames // 3):
                t = i * 60.0 / (args.frames // 3)
                P, R = traj.pose(t)
                img = world.render(cam, R, P)
                f = extractor.extract(jnp.asarray(img, jnp.float32),
                                      n_features=args.n_feat, n_levels=8)
                d = np.asarray(f.desc_pm1)[np.asarray(f.valid)]
                descs.append(d)

    alld = np.concatenate(descs, 0)
    print(f"training on {len(alld)} descriptors -> {args.words} words",
          file=sys.stderr)
    key = jax.random.PRNGKey(0)
    vocab = bow.train_vocab(jnp.asarray(alld, jnp.int8),
                            jnp.ones(len(alld), jnp.float32), key,
                            n_words=args.words, iters=args.iters)
    # idf over the training corpus, one document per harvested frame
    # (DBoW2's tf-idf word weights, ScoringObject.cpp / setNodeWeights role)
    doc_id = np.concatenate([np.full(len(d), i, np.int32)
                             for i, d in enumerate(descs)])
    idf = bow.compute_idf(jnp.asarray(alld, jnp.int8),
                          jnp.ones(len(alld), jnp.float32), vocab,
                          jnp.asarray(doc_id), len(descs))
    out = args.out or os.path.join(os.path.dirname(__file__), "..",
                                   "mc_slam", "assets", "vocab.npz")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    # pack +/-1 int8 -> bits for a compact artifact
    bits = np.packbits((np.asarray(vocab) > 0).astype(np.uint8), axis=1)
    np.savez_compressed(out, bits=bits, n_words=args.words,
                        idf=np.asarray(idf, np.float32))
    print(f"saved {out} ({os.path.getsize(out)/1024:.0f} KiB)")


if __name__ == "__main__":
    main()
