"""The cut scan (``csrc/median_cut.cu``, kernel ``cut_scan``) against its
roofline: 3 operations a live point and direction at 67 TFLOP/s f32, or
its bytes at 3.35 TB/s, whichever is longer."""

from portbench.metrics import _roofline


def read(run):
    return _roofline.share(run, "median_cut_scores", ("cut_scan",))
