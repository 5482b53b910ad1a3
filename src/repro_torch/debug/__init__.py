"""Debug-only runtime checks.

``repro_torch.debug.invariants`` holds the control plane's checks behind
``CORAL_SANITIZE=1``; nothing in here runs unless that flag is set, so
importing this package is always cheap.
"""
