"""The benchmark's own tests: they put the benchmark's folder and the
checkout's root on sys.path and run torch on a few threads."""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]
