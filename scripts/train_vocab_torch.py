"""Train the place-recognition vocabulary (codebook + idf) with the port.

`scripts/train_vocab.py` on `uvipslam_torch`: render synthetic sequences,
take each sampled frame's ORB descriptors through the port's frontend
(`refill_tracks`, `refresh_descriptors`), train the flat binary codebook
(`loop.vocab.train_codebook`), weight each word by its idf over the
frames (ln(N_frames / (1 + df)), at least 1e-3), and save both to
`--out`.

    python scripts/train_vocab_torch.py                  # on the card
    python scripts/train_vocab_torch.py --device cpu --seqs 1 --frames 2 \
        --size 64 80 --words 16 --out /tmp/vocab.npz

`--out` defaults to the port's `uvipslam_torch/loop/vocab_data.npz`, the
file `loop.reloc` loads, which the tests hold equal to the reference's:
with the defaults the frontend is the port's, so write elsewhere unless
the shipped vocabulary is to change in both packages.
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402


def collect_descriptors(device, n_seqs: int, frames_per_seq: int, H: int, W: int):
    """Descriptors of every sampled frame (every third), and the per-frame
    blocks (the documents of the idf)."""
    from uvipslam_torch.frontend.frame import Tracks, refill_tracks, refresh_descriptors
    from uvipslam_torch.io.synthetic import make_sequence

    docs = []
    for s in range(n_seqs):
        seq = make_sequence(n_frames=frames_per_seq * 3, H=H, W=W, n_points=3000, seed=100 + s,
                            motion=["arc", "excited", "loop"][s % 3], speed=1.0 + 0.3 * s)
        for f in range(0, frames_per_seq * 3, 3):
            img = torch.from_numpy(seq.images[f].astype(np.float32)).to(device)
            t = refill_tracks(Tracks.empty(400, device=device), img, f, n_features=400)
            t = refresh_descriptors(t, img)
            d = t.desc[t.valid].cpu().numpy()
            if len(d):
                docs.append(d)
        print(f"seq {s}: {sum(len(d) for d in docs)} descriptors total", flush=True)
    return np.concatenate(docs, 0), docs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--words", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--max-desc", type=int, default=60000)
    ap.add_argument("--seqs", type=int, default=6)
    ap.add_argument("--frames", type=int, default=12, help="sampled frames per sequence")
    ap.add_argument("--size", type=int, nargs=2, default=(240, 320), metavar=("H", "W"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(REPO, "uvipslam_torch", "loop",
                                                  "vocab_data.npz"))
    args = ap.parse_args(argv)

    from uvipslam_torch.frontend.tracker import step_device
    from uvipslam_torch.loop.vocab import train_codebook

    device = step_device(args.device)
    descs, docs = collect_descriptors(device, args.seqs, args.frames, *args.size)
    rs = np.random.RandomState(0)
    if len(descs) > args.max_desc:
        descs = descs[rs.choice(len(descs), args.max_desc, replace=False)]
    print(f"training {args.words}-word codebook on {len(descs)} descriptors")
    cb = train_codebook(descs, n_words=args.words, n_iters=args.iters)

    cbf = 2.0 * cb.astype(np.float32) - 1.0
    df = np.zeros(args.words, np.int64)
    for d in docs:
        D = (256 - (2.0 * d.astype(np.float32) - 1.0) @ cbf.T) / 2
        df[np.unique(D.argmin(1))] += 1
    # a word in every frame carries no information, never negative information
    idf = np.maximum(np.log(len(docs) / (1.0 + df)).astype(np.float32), 1e-3)

    np.savez_compressed(args.out, codebook=cb.astype(np.int8), idf=idf)
    print(f"saved {args.out}: codebook {cb.shape}, idf range [{idf.min():.3f}, "
          f"{idf.max():.3f}], words used {int((df > 0).sum())}/{args.words}")


if __name__ == "__main__":
    main()
