"""Entry of the benchmark: python3 mcbench/run.py --workload NAME --seed N
--seconds S --trace 0|1, from the root of a checkout (harness.py)."""
import os
import sys

if __name__ == "__main__":
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[0] = root
    from mcbench import harness
    sys.exit(harness.main(sys.argv[1:]))
