"""``python -m reporter_tpu_torch.analysis``: the port's gates from the
command line (the rules and waivers of tests/test_torch_static_analysis.py,
tests/test_torch_slo_contract.py and tests/test_torch_device_contract.py).

  (no flags)          the lint over reporter_tpu_torch/ and chip_smoke.py,
                      then the SLO contract;
  --lint, --slo       either alone (flags combine);
  --device            the device contract: every wire entry x arm x layout
                      x path and the scatters under the aten recorder,
                      then the compile manifest and the HBM bound, on
                      ``--on`` (cuda unless the caller asks for the CPU:
                      the card adds sync debug "error" and the manifest's
                      card sections; without a card cuda raises);
  --json              --device's result as two JSON lines (the audit, the
                      manifest), as chip_smoke.py's [analysis:*] read it;
  --update-manifest   regenerate analysis/compile_manifest.py's GOLDEN
                      block on a card (intentional changes only; commit
                      the diff).

Exit 1 on any unwaived finding or manifest drift.
"""

import argparse


def _main() -> int:
    ap = argparse.ArgumentParser(prog="python -m reporter_tpu_torch.analysis")
    ap.add_argument("--lint", action="store_true", help="run the lint")
    ap.add_argument("--slo", action="store_true",
                    help="validate the committed SLO specs")
    ap.add_argument("--device", action="store_true",
                    help="run the device contract and the compile manifest")
    ap.add_argument("--on", default="cuda",
                    help="the device of --device (cuda, or cpu by request)")
    ap.add_argument("--json", action="store_true",
                    help="print --device's result as JSON lines")
    ap.add_argument("--update-manifest", action="store_true",
                    help="regenerate the golden compile manifest (a card)")
    args = ap.parse_args()
    if args.update_manifest:
        from reporter_tpu_torch.analysis.compile_manifest import update_golden

        print(f"golden manifest rewritten: {update_golden()}")
        return 0
    if not (args.lint or args.slo or args.device):
        args.lint = args.slo = True
    rc = 0
    if args.lint:
        from reporter_tpu_torch.analysis.lint_rules import main as lint_main

        rc |= lint_main()
    if args.slo:
        from reporter_tpu_torch.analysis.slo_contract import main as slo_main

        rc |= slo_main()
    if args.device:
        from reporter_tpu_torch.analysis.device_contract import \
            main as device_main

        rc |= device_main(device=args.on, as_json=args.json)
    return rc


raise SystemExit(_main())
