"""Serving: the FPCA batch pipeline, the multi-camera stream server, event
taps and saliency, the fleet controller and its report; and the
language-model serving steps (:mod:`repro_torch.serving.serve_step`).

Every entry point runs on the CUDA card unless the pipeline is built with
``device="cpu"``; every fused launch on the card is one launch of the
fpca_conv kernel."""

from repro_torch.serving.events import EventPacket, EventStats, EventTap, segment_events
from repro_torch.serving.fleet import FleetAdmissionError, FleetConfig, FleetController
from repro_torch.serving.fpca_pipeline import (
    CalibrationKeyError,
    FPCAPipeline,
    FrontendRequest,
    PipelineStats,
)
from repro_torch.serving.observe import assert_reconciled, fleet_report, render_fleet_report
from repro_torch.serving.saliency import saliency_mask
from repro_torch.serving.streaming import (
    StreamFrameResult,
    StreamServer,
    StreamSession,
    StreamStats,
)

__all__ = [
    "CalibrationKeyError",
    "EventPacket",
    "EventStats",
    "EventTap",
    "FPCAPipeline",
    "FleetAdmissionError",
    "FleetConfig",
    "FleetController",
    "FrontendRequest",
    "PipelineStats",
    "StreamFrameResult",
    "StreamServer",
    "StreamSession",
    "StreamStats",
    "assert_reconciled",
    "fleet_report",
    "render_fleet_report",
    "saliency_mask",
    "segment_events",
]
