"""anchor_refine_roofline: the refinement kernel (`csrc/anchor_refine.cu`)
in the traced dive, its launches' bounds over their device time, in %
(`roofline.py`)."""

import roofline


def read(run):
    return roofline.refine_share(run.hand, run.starts, run.image_hw, run.live_share)
