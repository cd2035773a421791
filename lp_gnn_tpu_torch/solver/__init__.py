"""The LP solver: HiGHS through scipy's vendored bindings, and the crash
basis of the warm-start baseline."""
