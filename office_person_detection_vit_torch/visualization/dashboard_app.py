"""Streamlit session browser (reference
src/visualization/dashboard_app.py:34-526).

Read-only dashboard beside the pipeline: session picker, phase status,
KPI cards, zone-count charts, image grids, floor-trajectory rendering.
Mirrors ``office_person_detection_vit_tpu/visualization/dashboard_app.py``;
the floor trajectories are drawn with OpenCV (``scatter_chart``), as the
port's charts are. Launch: ``streamlit run
office_person_detection_vit_torch/visualization/dashboard_app.py``.
Streamlit is an optional dependency — importing this module without it
raises a clear error only at ``main()``. A session without tracked floor
coordinates projects its tracks through its homography on ``device``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def main(output_dir: str = "output", device: str = "auto") -> None:  # pragma: no cover - UI code
    try:
        import streamlit as st
    except ImportError as e:
        raise SystemExit(
            "streamlit is not installed; the dashboard is optional "
            "(pip install streamlit)"
        ) from e

    import pandas as pd

    from .dashboard_utils import SessionDataLoader

    st.set_page_config(page_title="Office person detection", layout="wide")
    st.title("Office person detection — session browser")

    sessions = SessionDataLoader.list_sessions(output_dir)
    if not sessions:
        st.warning(f"no sessions under {output_dir}/")
        return
    session = st.sidebar.selectbox("Session", sessions)
    loader = SessionDataLoader(Path(output_dir) / session, device=device)

    # ------------------------------------------------------------- status
    st.sidebar.subheader("Phase status")
    for phase, status in loader.phase_status().items():
        icon = {"completed": "✅", "failed": "❌", "skipped": "⏭"}.get(status, "⏳")
        st.sidebar.write(f"{icon} {phase}: {status}")

    summary = loader.summary() or {}
    stats = summary.get("statistics", {})
    c1, c2, c3, c4 = st.columns(4)
    c1.metric("Frames", stats.get("frames_extracted", "—"))
    c2.metric("Detections", stats.get("total_detections", "—"))
    c3.metric("Avg/frame", f"{stats.get('avg_detections_per_frame', 0):.2f}")
    c4.metric("Zones", stats.get("zones_count", "—"))

    # --------------------------------------------------------- zone counts
    zones, rows = loader.zone_counts()
    if rows:
        st.subheader("Zone occupancy")
        df = pd.DataFrame(rows)
        for z in zones:
            df[z] = pd.to_numeric(df[z], errors="coerce")
        st.line_chart(df.set_index("timestamp")[zones])

    # -------------------------------------------------------- performance
    perf = summary.get("performance", {})
    if perf:
        st.subheader("Phase timings")
        st.dataframe(
            pd.DataFrame(
                [{"phase": k, **v} for k, v in perf.items()]
            ).set_index("phase")
        )

    # ------------------------------------------------------------- imagery
    tab_det, tab_floor, tab_traj, tab_train = st.tabs(
        ["Detections", "Floormaps", "Trajectories", "Training"]
    )
    with tab_det:
        for img in loader.images("02_detection", limit=12):
            st.image(str(img), caption=img.name, width=400)
    with tab_floor:
        for img in loader.images("06_visualization", limit=12):
            st.image(str(img), caption=img.name, width=400)
    with tab_traj:
        traj = loader.floor_trajectories()
        if traj:
            import tempfile

            from .visualizer import _COLORS, scatter_chart

            groups = [(f"id {tid}", np.asarray(pts), _COLORS[i % len(_COLORS)], "o")
                      for i, (tid, pts) in enumerate(traj.items())]
            segments = [(p[:-1], p[1:]) for _, p, _, _ in groups]
            with tempfile.TemporaryDirectory() as tmp:
                png = scatter_chart(groups, Path(tmp) / "trajectories.png", "Floor trajectories", (8, 6),
                                    segments=segments, invert_y=True, legend=len(traj) <= 15)
                st.image(png.read_bytes())
        else:
            st.info("no tracked floor coordinates in this session")
    with tab_train:
        # Fine-tune runs (tools/train_detr.py checkpoints under runs/):
        # loss curve + per-eval quality table + recipe KPIs.
        from .dashboard_utils import (
            list_training_runs,
            load_training_history,
            training_summary,
        )

        runs = list_training_runs("runs")
        if not runs:
            st.info("no training runs under runs/ (tools/train_detr.py "
                    "--checkpoint runs/<name>)")
        else:
            run = st.selectbox("Training run", runs)
            history = load_training_history(Path("runs") / run)
            if history is None:
                st.warning("history.json unreadable")
            else:
                s = training_summary(history)
                cols = st.columns(4)
                cols[0].metric("steps", s["steps"])
                cols[1].metric("last epoch loss",
                               f"{s['last_loss']:.3f}" if s["last_loss"]
                               is not None else "—")
                cols[2].metric("best eval F1",
                               f"{s.get('best_f1', 0):.3f}"
                               if "best_f1" in s else "—")
                cols[3].metric("best eval mAP",
                               f"{s.get('best_map', 0):.3f}"
                               if "best_map" in s else "—")
                if s["recipe"]:
                    st.caption(f"recipe: {s['recipe']}")
                epochs = [e for e in history.get("epoch_losses", [])
                          if e is not None]
                if epochs:
                    st.line_chart(pd.DataFrame({"epoch loss": epochs}))
                if history.get("evals"):
                    st.dataframe(pd.DataFrame(history["evals"]))


if __name__ == "__main__":  # pragma: no cover
    main()
