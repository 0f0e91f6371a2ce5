"""extract_patches_roofline: the patch-pull kernel
(`csrc/extract_patches.cu`) in the traced dive, its launches' bounds over
their device time, in % (`roofline.py`)."""

import roofline


def read(run):
    return roofline.share(run.hand, "extract_patches_kernel", roofline.pull_launch)
