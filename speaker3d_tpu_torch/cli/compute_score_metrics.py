"""Trial scoring + EER/minDCF CLI.

The counterpart of ``speaker3d_tpu/cli/compute_score_metrics.py``
(reference: speakerlab/bin/compute_score_metrics.py), with the same flags
plus ``--device``: collect embedding archives for the enrol and test sides,
score each trial list by cosine (``eval.scoring.score_trials``, float64 on
``--device``), write `<trial>.score` files ("enrol test label score"), log
EER / EER threshold / minDCF into `result.metrics`, and, where matplotlib is
installed, save EER curve plots.

Usage:
  python -m speaker3d_tpu_torch.cli.compute_score_metrics \
      --enrol_data embeddings --test_data embeddings \
      --scores_dir scores --trials trials.txt [--device cuda]
"""

from __future__ import annotations

import argparse
import os

from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from speaker3d_tpu_torch.eval.scoring import load_embeddings, load_trials, score_trials
from speaker3d_tpu_torch.utils.metrics import compute_eer, compute_min_dcf, fnr_fpr_curve


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Compute scores and metrics")
    p.add_argument("--enrol_data", required=True)
    p.add_argument("--test_data", required=True)
    p.add_argument("--scores_dir", required=True)
    p.add_argument("--trials", nargs="+", required=True)
    p.add_argument("--p_target", default=0.01, type=float)
    p.add_argument("--c_miss", default=1.0, type=float)
    p.add_argument("--c_fa", default=1.0, type=float)
    p.add_argument("--det_plot", action="store_true",
                   help="also write a normal-deviate DET curve per trial "
                        "(reference: utils/score_metrics.py plot_det_curve)")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device of the trial cosines; 'cpu' must be "
                        "asked for (and gives the JAX package's bytes)")
    return p.parse_args(argv)


def _plots(scores_dir, name, fnr, fpr, eer, det_plot) -> None:
    """EER curve (and DET curve) PNGs; skipped where matplotlib is absent."""
    try:
        import matplotlib
    except ImportError:
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from speaker3d_tpu_torch.utils.metrics import plot_det_curve

    plt.figure()
    plt.plot(fpr, fnr)
    plt.plot([0, 1], [0, 1], "r--")
    plt.xlabel("FPR")
    plt.ylabel("FNR")
    plt.title(f"{name} EER={100*eer:.3f}%")
    plt.grid(True)
    plt.savefig(os.path.join(scores_dir, f"{name}_eer_curves.png"))
    plt.close()
    if det_plot:
        plot_det_curve(fnr, fpr, os.path.join(scores_dir,
                                               f"{name}_det_curve.png"))


def main(argv=None):
    args = get_args(argv)
    from speaker3d_tpu_torch.parallel.mesh import init_multihost
    init_multihost(device=args.device)  # under torchrun: the process group
    device = resolve_device(args.device)
    os.makedirs(args.scores_dir, exist_ok=True)
    result_path = os.path.join(args.scores_dir, "result.metrics")

    enrol = load_embeddings(args.enrol_data)
    test = (enrol if os.path.abspath(args.test_data)
            == os.path.abspath(args.enrol_data) else
            load_embeddings(args.test_data))

    lines_out = []
    for trial_path in args.trials:
        name = os.path.basename(trial_path)
        trials = load_trials(trial_path)
        scores, labels = score_trials(enrol, test, trials, device=device)

        with open(os.path.join(args.scores_dir, f"{name}.score"), "w") as f:
            for (e, t, y), s in zip(trials, scores):
                f.write(f"{e} {t} {y} {s:.5f}\n")

        fnr, fpr = fnr_fpr_curve(scores, labels)
        eer, thres = compute_eer(scores, labels, return_threshold=True)
        min_dcf = compute_min_dcf(fnr=fnr, fpr=fpr, p_target=args.p_target,
                                  c_miss=args.c_miss, c_fa=args.c_fa)
        lines_out += [
            f"Results of {name} is:",
            f"EER = {100 * eer:.4f}",
            f"EER_thres = {thres:.4f}",
            (f"minDCF (p_target:{args.p_target} c_miss:{args.c_miss} "
             f"c_fa:{args.c_fa}) = {min_dcf:.4f}"),
        ]
        _plots(args.scores_dir, name, fnr, fpr, eer, args.det_plot)

    with open(result_path, "w") as f:
        f.write("\n".join(lines_out) + "\n")
    print("\n".join(lines_out))


if __name__ == "__main__":
    main()
