"""Serving: the LM zoo's prefill/decode steps (``engine``) and the
collaborative-intelligence split-inference gateway (``gateway`` with
channel, scheduler, batcher, executor, rate control and telemetry), as in
``repro.serve``.

The LM engine pulls in the model zoo, so it is not imported here; use
``from repro_torch.serve.engine import ...``. ``MeshExecutor`` is the
sharded cloud tier (``serve/mesh_executor.py``).
"""
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.pipeline import Capabilities, NegotiationError
from repro_torch.serve.batcher import (BucketKey, DecodedRequest,
                                       EncodedRequest, MicroBatch,
                                       MicroBatcher, PlanBucketKey,
                                       bucket_sizes)
from repro_torch.serve.channel import (ChannelConfig, FrameDelivery,
                                       SimulatedChannel, Transmission)
from repro_torch.serve.executor import (AdmissionDecision, AdmissionPolicy,
                                        AlwaysAdmit, CalibratedCostModel,
                                        CloudExecutor, CompositeAdmission,
                                        CostModel, ExecTicket,
                                        LinearCostModel, MeasuredCost,
                                        MultiQueueExecutor,
                                        QueueDepthAdmission, RequestShed,
                                        SerialExecutor, TokenBucketAdmission,
                                        priority_depth_limits)
from repro_torch.serve.gateway import (GatewayFederation, GatewayResponse,
                                       MultiTenantGateway, ServingGateway,
                                       TenantRequest, serve_federated)
from repro_torch.serve.mesh_executor import (MeshExecutor,
                                             seed_cost_from_program)
from repro_torch.serve.rate_control import (ContentKeyedController,
                                            OperatingPoint, RateController,
                                            RDPoint, build_rd_table,
                                            codec_revision,
                                            load_or_build_rd_table, rd_grid,
                                            rd_table_from_json,
                                            rd_table_to_json,
                                            session_bits_per_frame)
from repro_torch.serve.scheduler import (DeficitRoundRobinScheduler,
                                         TenantSpec, UplinkJob)
from repro_torch.serve.telemetry import (DegradeRecord, RequestRecord,
                                         ShedRecord, Telemetry,
                                         jain_fairness)

__all__ = [
    "BucketKey", "DecodedRequest", "EncodedRequest", "MicroBatch",
    "MicroBatcher", "PlanBucketKey", "bucket_sizes",
    "Capabilities", "NegotiationError",
    "ChannelConfig", "FrameDelivery", "SimulatedChannel", "Transmission",
    "AdmissionDecision", "AdmissionPolicy", "AlwaysAdmit",
    "CalibratedCostModel", "CloudExecutor", "CompositeAdmission",
    "CostModel", "ExecTicket", "LinearCostModel", "MeasuredCost",
    "MultiQueueExecutor", "QueueDepthAdmission",
    "RequestShed", "SerialExecutor", "TokenBucketAdmission",
    "priority_depth_limits",
    "GatewayFederation", "GatewayResponse", "MultiTenantGateway",
    "ServingGateway", "TenantRequest", "serve_federated",
    "MeshExecutor", "seed_cost_from_program",
    "ContentKeyedController", "OperatingPoint",
    "RateController", "RDPoint", "build_rd_table", "codec_revision",
    "load_or_build_rd_table", "rd_grid", "rd_table_from_json",
    "rd_table_to_json", "session_bits_per_frame",
    "DeficitRoundRobinScheduler", "TenantSpec", "UplinkJob",
    "DegradeRecord", "RequestRecord", "ShedRecord", "Telemetry",
    "jain_fairness",
    "MetricsRegistry", "Tracer",
]
