"""Cells cut to a size a CPU test run holds: narrow widths, small images,
short pools (`tiny_spec`), or the published widths with a batch of two
(`control_spec`, where the bfloat16 control's gap only shows at full
width). Only the tests use these; every run on the chip is at the
configuration's own sizes."""

from benchmark.harness import cell

TINY = {
    "restorer": dict(
        network=dict(input_width=32, input_height=32, narrow=0.0625),
        traffic=dict(pool=8, batch=4, height=32, width=32, keep=2,
                     warmup_calls=1)),
    "sr_engine": dict(
        network=dict(num_feat=16, num_conv=4),
        engine=dict(tile=32, halo=8),
        calibration=dict(height=32, width=32),
        traffic=dict(pool=3, height=70, width=100, grid_tile=32,
                     check_block=64, warmup_calls=1)),
}


def tiny_spec(workload: str) -> cell.Spec:
    spec = cell.Spec(workload)
    cut = TINY[spec.config["program"]]
    for key, value in cut.items():
        if key == "traffic":
            spec.traffic.update(value)
        else:
            spec.config[key].update(value)
    return spec


# the restorer's control needs the published widths: at narrow ones the
# bfloat16 gap stays near the limit
FEW = dict(pool=2, batch=2, keep=1, warmup_calls=0)


def control_spec(workload: str) -> cell.Spec:
    spec = cell.Spec(workload)
    if spec.config["program"] != "restorer":
        return tiny_spec(workload)
    spec.traffic.update(FEW)
    return spec
