from spjoin_lint_torch.cli import main

raise SystemExit(main())
