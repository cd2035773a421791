"""The LP solver engines: HiGHS through scipy's vendored bindings and the
native C++ simplex (``native/tpulp.cc``, built with g++ at first use), and
the crash basis of the warm-start baseline."""
