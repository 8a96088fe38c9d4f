import sys

from lmpc_bench.run import main

sys.exit(main())
