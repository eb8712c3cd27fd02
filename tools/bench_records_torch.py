"""Input-feed throughput of the PyTorch port: directory tree against packed
``.duplrec`` shard (counterpart of ``tools/bench_records.py``).

    python tools/bench_records_torch.py [--n-images 512] [--size 192]

Writes an N-image VOC-structured tree of synthetic scenes
(``data.voc.write_synthetic_voc``), packs its train split, and measures the
samples/s of ``data.pipeline.PrefetchLoader`` over both datasets with the
same workers, batch and augmentation.  On a local disk the two are close
(the decode dominates); the packed shard's gain, one open and ``pread`` in
place of a metadata round trip and an open a file, grows with the file
system's latency.  Host only: no card is used.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def measure(ds, batch: int, workers: int, n_batches: int, seed: int = 0) -> float:
    """Samples/s of ``n_batches`` batches after one warm-up batch."""
    from dupl_tpu_torch.data.pipeline import PrefetchLoader

    loader = PrefetchLoader(ds, batch, seed=seed, num_workers=workers)
    try:
        it = iter(loader)
        next(it)
        t0 = time.perf_counter()
        for _ in range(n_batches):
            next(it)
        dt = time.perf_counter() - t0
    finally:
        loader.stop()
    return batch * n_batches / dt


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n-images", type=int, default=512)
    p.add_argument("--size", type=int, default=192)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--batches", type=int, default=40)
    p.add_argument("--crop-size", type=int, default=192)
    p.add_argument("--keep", default=None,
                   help="directory to build in (default: a temporary one)")
    args = p.parse_args(argv)

    from dupl_tpu_torch.data.records import RecordVocClsDataset, pack_voc
    from dupl_tpu_torch.data.voc import VocClsDataset, write_synthetic_voc

    work = args.keep or tempfile.mkdtemp(prefix="duplrec_bench_")
    tree = os.path.join(work, "voc")
    try:
        lists = os.path.join(tree, "lists")
        if not os.path.isdir(tree):
            write_synthetic_voc(tree, [], train_sizes=[(args.size, args.size)]
                                * args.n_images)
        shard = os.path.join(work, "train.duplrec")
        t0 = time.perf_counter()
        pack_voc(tree, lists, "train_aug", shard)
        pack_s = time.perf_counter() - t0

        kw = dict(batch=args.batch, workers=args.workers,
                  n_batches=args.batches)
        r_dir = measure(VocClsDataset(tree, lists, "train_aug",
                                      crop_size=args.crop_size), **kw)
        r_rec = measure(RecordVocClsDataset(shard, crop_size=args.crop_size),
                        **kw)
        size_mb = os.path.getsize(shard) / 1e6
        print(f"{args.n_images} images @{args.size}px, batch {args.batch}, "
              f"{args.workers} workers, {args.batches} batches")
        print(f"pack: {pack_s:.2f} s ({size_mb:.1f} MB shard)")
        print(f"directory tree: {r_dir:.1f} samples/s")
        print(f"packed shard:   {r_rec:.1f} samples/s "
              f"({(r_rec / r_dir - 1) * 100:+.1f}%)")
        return {"pack_s": pack_s, "shard_mb": size_mb,
                "directory_samples_per_s": r_dir,
                "records_samples_per_s": r_rec}
    finally:
        if args.keep is None:
            shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
