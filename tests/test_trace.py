"""Trace reduction (mc_slam.utils.trace) on hand-made device events."""
from mc_slam.utils import trace


def _ev(dev, name, start, dur, module, op):
    return (dev, "stream", name, start, dur,
            {"hlo_module": module, "name": op})


def test_summarize_busy_union_modules_and_scopes():
    ev = [
        _ev("/device:GPU:0", "gemm", 0, 10, "jit_frame_pipeline_vi_pair",
            "jit(frame_pipeline_vi_pair)/search_by_projection/dot_general"),
        _ev("/device:GPU:0", "fusion", 5, 10, "jit_frame_pipeline_vi_pair",
            "jit(frame_pipeline_vi_pair)/pose_only/add"),
        _ev("/device:GPU:0", "fusion", 40, 20, "jit_window_vi_ba_map",
            "jit(window_vi_ba_map)/idp_schur/dot_general"),
    ]
    s = trace.summarize(ev, scopes=("search_by_projection", "idp_schur"))
    assert s["window_ns"] == 60
    assert s["busy_ns"] == 15 + 20          # [0, 15) and [40, 60)
    assert s["kernel_ns"] == 40
    assert s["by_module"] == {"jit_window_vi_ba_map": 20,
                              "jit_frame_pipeline_vi_pair": 20}
    assert s["by_scope"] == {"search_by_projection": 10, "idp_schur": 20}
    f = trace.summarize(ev, scopes=("search_by_projection",),
                        module_filter="frame_pipeline_vi")
    assert f["kernel_ns"] == 20 and f["by_scope"]["search_by_projection"] == 10
    assert f["by_op"] == {
        "jit(frame_pipeline_vi_pair)/search_by_projection/dot_general": 10,
        "jit(frame_pipeline_vi_pair)/pose_only/add": 10}
    assert trace.summarize(ev, depth=1)["by_op"] == {
        "jit(frame_pipeline_vi_pair)": 20, "jit(window_vi_ba_map)": 20}
    assert trace.summarize([], module_filter="x")["kernel_ns"] == 0
