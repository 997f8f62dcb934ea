import time

_T0 = time.perf_counter()

if __name__ == "__main__":
    import sys

    from amc_bench.run import main

    sys.exit(main(t0=_T0))
