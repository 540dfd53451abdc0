"""R13 fixture: the tests/ half of the chaos-point closure."""
from ray_tpu_torch import chaos


def test_exercises_points():
    # negative: this spec makes fixture.point.tested "exercised"
    chaos.configure(3, "fixture.point.tested@1=error")
    # positive: no runtime inject declares this point
    spec = "fixture.point.ghost@1=drop"
    return spec
