"""Parity of the metric networks' weights: a PASS/FAIL verdict per embedder.

Port of playableenvironments_tpu/cli/validate_metric_weights.py, with
`--device` (default the card; without one it raises unless `--device cpu`):

    # The self-check (no weight files): synthesized published-layout states
    # through the converters and networks, against the shipped goldens.
    python -m playableenvironments_tpu_torch.cli.validate_metric_weights [--device cuda|cpu]

    # A user's weight files: record their signatures once, compare later.
    python -m playableenvironments_tpu_torch.cli.validate_metric_weights --inception pt_inception-2015-12-05.pth \\
        --i3d i3d_kinetics_rgb.npz --lpips_lins lpips_vgg.pth --vgg16 vgg16.pth --vgg19 vgg19.pth \\
        --write_goldens my_goldens.json
    python -m playableenvironments_tpu_torch.cli.validate_metric_weights --inception ... --goldens my_goldens.json

The networks run on `--device` in IEEE f32 (compat/weight_validation.py).
Exit code 0 only when every requested check passes; an embedder the goldens
record and this run did not compute is reported MISSING, one computed
without a golden NO_GOLDEN. `main()` returns the report (the signatures
with `--write_goldens`).
"""

from __future__ import annotations

import argparse
import json


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--inception", help="torchvision/pytorch_fid InceptionV3 .pth")
    parser.add_argument("--i3d", help="tfhub Kinetics-400 RGB I3D variables .npz")
    parser.add_argument("--lpips_lins", help="lpips package vgg.pth (linear heads)")
    parser.add_argument("--vgg16", help="torchvision VGG16 .pth (LPIPS backbone)")
    parser.add_argument("--vgg19", help="torchvision VGG19 .pth (perceptual loss)")
    parser.add_argument("--goldens", default=None,
                        help="golden signature JSON to compare against (default: the shipped synthetic goldens "
                             "when no weight files are given)")
    parser.add_argument("--write_goldens", default=None,
                        help="write the computed signatures to this JSON instead of comparing")
    parser.add_argument("--rtol", type=float, default=2e-3)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    from playableenvironments_tpu_torch.compat import weight_validation as wv
    from playableenvironments_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    any_files = any((args.inception, args.i3d, args.lpips_lins, args.vgg16, args.vgg19))
    if args.vgg16 and not args.lpips_lins:
        raise SystemExit("--vgg16 is the LPIPS backbone and is only validated through the LPIPS head: pass "
                         "--lpips_lins with it (for the phase-2 perceptual-loss VGG, pass --vgg19)")
    if any_files and not (args.goldens or args.write_goldens):
        raise SystemExit("real weight files need --write_goldens (first run: record their signatures) or --goldens "
                         "(compare against a recorded file); the shipped golden_activations.json only matches the "
                         "synthetic self-check and would always FAIL real weights")
    variables = {}
    if not any_files:
        print("no weight files given: running the synthetic self-check (converters + embedders over the pinned "
              "published layouts)")
        variables = wv.synthetic_variables()
    else:
        from playableenvironments_tpu_torch.compat import metric_weights as mw
        from playableenvironments_tpu_torch.eval.perceptual import VGG19_PLAN, convert_torch_vgg_state_dict

        if args.inception:
            variables["inception_v3"] = mw.load_torch_inception_weights(args.inception)
        if args.i3d:
            variables["i3d"] = mw.load_tfhub_i3d_weights(args.i3d)
        if args.lpips_lins:
            if not args.vgg16:
                raise SystemExit("--lpips_lins requires --vgg16 (the backbone)")
            variables["lpips"] = mw.load_torch_lpips_weights(args.lpips_lins, args.vgg16)
        if args.vgg19:
            variables["vgg19"] = convert_torch_vgg_state_dict(mw.read_torch_state_dict(args.vgg19), VGG19_PLAN)

    signatures = wv.compute_signatures(variables, device)

    if args.write_goldens:
        path = wv.write_goldens(signatures, args.write_goldens)
        print(f"golden signatures written to {path}")
        return signatures

    golden = wv.load_goldens(args.goldens)
    report = wv.compare_signatures(signatures, golden, rtol=args.rtol)
    failed, missing = [], []
    for name, verdict in sorted(report.items()):
        gap = (f" (largest relative gap {wv.largest_relative_gap(verdict['computed'], verdict['golden']):.3e})"
               if "computed" in verdict else "")
        print(f"{name}: {verdict['status']}{gap}")
        if verdict["status"] == "MISSING":
            # Not fatal, but visible: the goldens record this embedder and
            # this run did not compute it.
            missing.append(name)
        elif verdict["status"] != "PASS":
            failed.append(name)
            if "computed" in verdict:
                print(f"  computed: {json.dumps(verdict['computed'])}")
                print(f"  golden:   {json.dumps(verdict['golden'])}")
    if failed:
        raise SystemExit(f"FAILED: {failed}")
    if missing:
        print(f"passed, but NOT validated this run (no weights given): {missing}")
    else:
        print("all checks passed")
    return report


if __name__ == "__main__":
    main()
