"""``python -m keystone_tpu_torch.pipelines <Name> [flags]``: the
launcher (`python -m keystone_tpu_torch`) run from the package that
holds the apps (`keystone_tpu/pipelines/__main__.py:1-18`):

    KEYSTONE_TRACE=run.json python -m keystone_tpu_torch.pipelines \\
        MnistRandomFFT --num-ffts 2 --device cpu

With ``KEYSTONE_TRACE`` set the run writes a Chrome trace at exit;
``python -m keystone_tpu_torch.telemetry run.json`` summarizes it.
"""

import sys

from ..__main__ import main

if __name__ == "__main__":
    sys.exit(main())
