"""Peptide identification as a KNN join on the PyTorch port — the paper's
motivating workload (the twin of examples/peptide_search.py, through
``repro_torch.core``).

Experimental MS/MS spectra (R) join against a library of theoretical
spectra (S) under dot-product similarity; each experimental spectrum is
matched to its k best peptide candidates.  Spectra are sparse vectors:
m/z binned at 0.1 Da (dim index = m/z * 10), peak intensity as the value
— exactly the paper's §5 preprocessing.  Runs on CUDA unless ``--device
cpu`` is given.

  PYTHONPATH=src python examples/torch_peptide_search.py [--nr 500 --ns 5000] [--device cpu]
"""
import argparse
import time

from repro_torch.core import JoinSpec, JoinStats, SparseKNNIndex
from repro_torch.sparse import spectra_like


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nr", type=int, default=500, help="experimental spectra")
    ap.add_argument("--ns", type=int, default=5000, help="library spectra")
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="compute device (cuda unless cpu)")
    args = ap.parse_args()

    # "experimental" spectra and a theoretical library; in a real pipeline
    # S comes from in-silico digestion + fragmentation of a protein DB.
    experimental = spectra_like(args.nr, dim=20_000, peaks_mean=80, seed=42)
    library = spectra_like(args.ns, dim=20_000, peaks_mean=80, seed=7)

    # the library is the stable side: build its index once, then every
    # incoming batch of experimental spectra is just a query
    spec = JoinSpec(k=args.k, algorithm="iiib",
                    r_block=min(args.nr, 512), s_block=min(args.ns, 1024))
    index = SparseKNNIndex.build(library, spec, device=args.device)

    stats = JoinStats()
    t0 = time.time()
    result = index.query(experimental, stats=stats)
    ids, scores = result.ids.cpu().numpy(), result.scores.cpu().numpy()  # waits for the device
    dt = time.time() - t0
    print(f"searched {args.nr} spectra against {args.ns} candidates on {index.device} "
          f"in {dt:.2f}s ({args.nr / dt:.0f} spectra/s; "
          f"library prepared once in {index.stats.build_wall_s:.2f}s)")
    print(f"work: {stats.list_entries} indexed-feature touches, "
          f"{stats.device_dispatches} device dispatches, "
          f"{stats.index_builds} query-time index builds")
    print("\nspectrum -> best peptide matches (id: score):")
    for i in range(min(5, args.nr)):
        matches = ", ".join(
            f"{ids[i, j]}: {scores[i, j]:.3f}" for j in range(args.k)
            if scores[i, j] > 0
        )
        print(f"  spectrum {i}: {matches}")


if __name__ == "__main__":
    main()
