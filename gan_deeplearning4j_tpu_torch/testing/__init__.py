"""Fault injection for tests and drills (torch twin of
``gan_deeplearning4j_tpu/testing``); nothing on the training path imports
this package."""

from gan_deeplearning4j_tpu_torch.testing.chaos import (
    ChaosInjector,
    ChaosSchedule,
    CorruptRecordSource,
    DeviceLostError,
    FlakyReader,
    FlakySource,
    HangingSource,
    InjectedCrash,
    LeakyDispatchSource,
    NanSource,
    ReadbackHang,
    SlowLorisClient,
    SlowRequestSource,
    StallingSource,
    TenantFeedPoisoner,
    kill_replica,
    kill_replica_process,
    mid_body_disconnect,
    poison_checkpoint_dir,
    poison_fleet_checkpoint_dir,
    poison_tenant_params,
    wedge_replica,
)

__all__ = ["ChaosInjector", "ChaosSchedule", "CorruptRecordSource",
           "DeviceLostError", "FlakyReader", "FlakySource", "HangingSource",
           "InjectedCrash", "LeakyDispatchSource", "NanSource",
           "ReadbackHang", "SlowLorisClient", "SlowRequestSource",
           "StallingSource", "TenantFeedPoisoner", "kill_replica",
           "kill_replica_process", "mid_body_disconnect",
           "poison_checkpoint_dir", "poison_fleet_checkpoint_dir",
           "poison_tenant_params", "wedge_replica"]
