"""Named deployment presets: canonical scenario families for benchmarks and
examples. Doppler values follow f_d = v / lambda_c at a ~2 GHz carrier
(lambda_c ~ 0.15 m): pedestrian ~1.4 m/s -> ~9 Hz, vehicular 30 m/s -> 200 Hz.
"""
from __future__ import annotations

from repro_torch.scenarios.scenario import ScenarioConfig

_PRESETS: dict[str, ScenarioConfig] = {
    # Many pedestrian users, dense small cells, steady churn from shops and
    # transit. 10 ms re-planning epochs: at pedestrian Doppler the channel
    # stays ~92% correlated between plans, so warm starts track it cheaply.
    "dense_urban": ScenarioConfig(
        name="dense_urban", n_users=24, n_aps=6, n_sub=8,
        epoch_dt_s=0.01, doppler_hz=9.0, speed_mps=1.4,
        arrival_rate_hz=2.0, cluster_frac=0.5, n_clusters=3,
        cluster_radius_m=40.0,
    ),
    # Vehicular speeds: 200 Hz Doppler fully decorrelates fading between
    # 50 ms epochs (rho = 0) -- the stress case where warm starts cannot help
    # and cold re-planning is the right strategy.
    "highway": ScenarioConfig(
        name="highway", n_users=12, n_aps=3, n_sub=4,
        epoch_dt_s=0.05, doppler_hz=200.0, speed_mps=30.0,
        arrival_rate_hz=1.0,
    ),
    # Most users packed around a couple of hotspots (stadium gates, cafes):
    # heavy intra-cell NOMA contention at the hotspot APs.
    "hotspot": ScenarioConfig(
        name="hotspot", n_users=16, n_aps=4, n_sub=6,
        epoch_dt_s=0.01, doppler_hz=6.0, speed_mps=0.8,
        cluster_frac=0.9, n_clusters=2, cluster_radius_m=25.0,
    ),
    # Massive static IoT: big U, nearly-frozen channels, rare battery-driven
    # churn -- the best case for the online warm start.
    "iot_massive": ScenarioConfig(
        name="iot_massive", n_users=48, n_aps=4, n_sub=12,
        epoch_dt_s=1.0, doppler_hz=0.02, speed_mps=0.0,
        arrival_rate_hz=0.2,
    ),
}


def names() -> list[str]:
    return sorted(_PRESETS)


def get(name: str) -> ScenarioConfig:
    try:
        return _PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; available: {names()}") from None
