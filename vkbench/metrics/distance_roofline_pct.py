"""The distance kernels' share of their roofline in a TF edit, in
percent: the least time their work takes on the card (``roofline.py``,
at the map's shape and skipmode) over their device time, both summed over
the edits of the profiled sub-window. The kernels are found by name
(csrc/distance.cu: ``scan_relax4_kernel``, ``relax_lines_kernel``)."""

from vkbench import roofline

NAMES = ("scan_relax4_kernel", "relax_lines_kernel")


def read(trace):
    n = trace.count("vkbench.edit")
    bound = roofline.edit_bound_ms(trace.context["map_shape_zyx"],
                                   trace.context["skipmode"])
    ms = sum(o["dur"] for o in trace.ops_in("vkbench.edit")
             if any(k in o["name"] for k in NAMES)) / 1e3
    if not n or bound is None or ms <= 0.0:
        return None
    return 100.0 * bound * n / ms
