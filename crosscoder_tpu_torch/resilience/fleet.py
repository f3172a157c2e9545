"""Fleet autoscaling policy: which grid shape for the ranks at hand, ported
from :mod:`crosscoder_tpu.resilience.fleet`.

On an elastic grow somebody must answer "how should the ``data`` ×
``model`` grid split the ranks we now have?". The answer lives behind one
call, :meth:`FleetPolicy.choose`, so the controller stays a membership
protocol and the shape stays a swappable policy:

- ``cfg.elastic_policy="fixed"`` (default): keep ``model_axis_size`` (the
  TP width shapes the dictionary sharding a restore re-derives) and give
  the data axis every other rank. A grow back to the starting rank count
  lands on the starting grid, which the bitwise drills lean on.
- ``cfg.elastic_policy="score"``: rank every valid split by a modeled step
  cost (:meth:`FleetPolicy.rank`, the port's own cost model; see there).

Hysteresis (dwell, debounce) is a membership decision and lives in the
:class:`~crosscoder_tpu_torch.resilience.elastic.ElasticController`; the
policy is a function of capacity. A pinned tuned artifact (``cfg.tuned``)
outranks both policies: the grid an artifact searched at this rank count
(the pinned one, or a ``TUNED.<topology>.json`` sibling of it) is taken as
it stands (:meth:`FleetPolicy._tuned_choice`).
"""

from __future__ import annotations

import dataclasses
import sys

from crosscoder_tpu_torch.parallel import comm_model

# The H100 SXM's published dense bf16 tensor-core peak, the figure the
# kernels' bounds use (csrc/fused_topk.cu). A part's published rate, not a
# measurement; with comm_model.NVLINK_GBPS it prices the score policy's
# candidates. Only the ranking matters to the policy.
PEAK_FLOPS = 989.4e12

# the loss's global scalar sums a data-parallel step all-reduces beside the
# gradients (the L2 and the L1 terms, f32)
_LOSS_SUM_BYTES = 8


@dataclasses.dataclass(frozen=True)
class MeshChoice:
    """One ``(data, model)`` split plus how the policy priced it."""

    n_data: int
    n_model: int
    score_ms: float | None = None   # modeled step cost; None = unscored
    detail: dict = dataclasses.field(default_factory=dict)


class FleetPolicy:
    """Grid-shape policy over the ranks at hand (``cfg.elastic_policy``)."""

    def __init__(self, cfg) -> None:
        self.cfg = cfg

    # -- the shape lattice -------------------------------------------------

    def candidate_shapes(self, n_devices: int) -> list[tuple[int, int]]:
        """Every ``(n_data, n_model)`` split of ``n_devices`` this config can
        run: the model axis shards the dictionary, so it must divide
        ``dict_size``; ``quant_grads`` and ``shard_sources`` pin pure data
        parallelism (the config's rules say the same)."""
        cfg = self.cfg
        out: list[tuple[int, int]] = []
        for m in range(1, n_devices + 1):
            if n_devices % m or cfg.dict_size % m:
                continue
            if m > 1 and (cfg.quant_grads or cfg.shard_sources):
                continue
            out.append((n_devices // m, m))
        return out

    # -- the decision ------------------------------------------------------

    def choose(self, n_devices: int, n_tenants: int = 1) -> MeshChoice:
        """The grid for ``n_devices`` ranks. ``n_tenants`` (a fleet's
        tenants a round) multiplies every candidate's cost alike: the
        ranking is unchanged, ``score_ms`` is the round's. The score policy
        falls back to the fixed one when its ranking is empty. A pinned tuned
        artifact for this rank count outranks both (:meth:`_tuned_choice`)."""
        tuned = self._tuned_choice(n_devices)
        if tuned is not None:
            return tuned
        if self.cfg.elastic_policy == "score":
            ranked = self.rank(n_devices, n_tenants)
            if ranked:
                return ranked[0]
            print("[crosscoder_tpu_torch] fleet: score policy produced no ranking; falling "
                  "back to the fixed shape", flush=True, file=sys.stderr)
        m = max(1, int(self.cfg.model_axis_size))
        if n_devices % m:
            raise ValueError(f"fleet: {n_devices} devices not divisible by the fixed TP width "
                             f"model_axis_size={m}")
        return MeshChoice(n_devices // m, m, None, {"policy": "fixed"})

    def _tuned_choice(self, n_devices: int) -> MeshChoice | None:
        """The grid a tuned artifact pins for ``n_devices`` ranks, or None
        when none applies: the pinned artifact itself first, then its
        ``TUNED.<topology>.json`` siblings over every valid TP width. Any
        trouble with an artifact is a miss, never an error: the re-mesh
        must not die on a torn file."""
        if not getattr(self.cfg, "tuned", ""):
            return None
        from pathlib import Path

        from crosscoder_tpu_torch.tune import artifact as tune_artifact

        def as_choice(art, src: str) -> MeshChoice | None:
            if art is None or int(art.mesh.get("n_devices", 0)) != n_devices:
                return None
            n_model = max(1, int(art.mesh.get("n_model", 1)))
            if n_devices % n_model:
                return None
            return MeshChoice(n_devices // n_model, n_model, None,
                              {"policy": "tuned", "artifact": src, "objective": art.objective})

        try:
            pinned = tune_artifact.load_tuned(self.cfg.tuned)
        except ValueError:
            pinned = None
        got = as_choice(pinned, str(self.cfg.tuned))
        if got is not None:
            return got
        root = Path(self.cfg.tuned).parent
        for _, n_model in self.candidate_shapes(n_devices):
            topo = tune_artifact.topology_key(n_devices, n_model)
            got = as_choice(tune_artifact.cached_artifact(root, topo),
                            str(tune_artifact.cache_path(root, topo)))
            if got is not None:
                return got
        return None

    # -- the port's cost model ---------------------------------------------

    def rank_params(self, n_model: int) -> int:
        """The parameters one rank holds at TP width ``n_model``: the
        encoder and decoder matrices, ``b_enc`` and ``log_theta`` split
        over ``model``, ``b_dec`` whole."""
        cfg = self.cfg
        d = cfg.n_models * cfg.d_in
        h = cfg.dict_size // n_model
        n = 2 * d * h + h + d
        if cfg.activation == "jumprelu":
            n += h
        return n

    def step_flops(self, n_data: int, n_model: int) -> float:
        """One rank's modeled step flops: the five dense products of a step
        at its shard shapes (rows ``batch_size / n_data``, columns
        ``dict_size / n_model``): the encoder's forward and weight
        gradient, the decoder's forward, weight gradient and activation
        gradient, 2 flops a multiply-add each."""
        cfg = self.cfg
        rows = cfg.batch_size / n_data
        return 10.0 * rows * cfg.n_models * cfg.d_in * cfg.dict_size / n_model

    def step_profile(self, n_data: int, n_model: int) -> comm_model.CommProfile:
        """One rank's modeled collective bytes a step, as a
        :class:`~crosscoder_tpu_torch.parallel.comm_model.CommProfile`: the
        data-parallel sum of every gradient in f32 (4 bytes a parameter of
        the rank's shards, one all-reduce a leaf) and the loss's global
        sums; at TP width above 1, the ``model`` sum of the decoder's f32
        output (``batch_size / n_data`` rows of ``n_models · d_in``). On
        ``train_dp`` this is the count ``comm_model.profile_width`` takes."""
        cfg = self.cfg
        by_op = {"all-reduce": 4 * self.rank_params(n_model) + _LOSS_SUM_BYTES}
        if n_model > 1:
            by_op["all-reduce"] += 4 * (cfg.batch_size // n_data) * cfg.n_models * cfg.d_in
        name = "train_dp_tp" if n_model > 1 else "train_dp"
        return comm_model.CommProfile(name, n_data * n_model, n_model, by_op)

    def rank(self, n_devices: int, n_tenants: int = 1) -> list[MeshChoice]:
        """Score every candidate split, cheapest modeled step first.

        The port's cost model (JAX's prices a split with XLA's
        ``compiled.cost_analysis()`` flops and the HLO's collective bytes,
        neither of which PyTorch has): the step's compute is
        :meth:`step_flops` at the H100's dense bf16 peak
        (:data:`PEAK_FLOPS`), its wire is
        :func:`comm_model.wire_bytes` of :meth:`step_profile` at
        ``axis_size=n_data`` over :data:`comm_model.NVLINK_GBPS`, serialized
        (no overlap), times ``n_tenants``. All of it is arithmetic on the
        config: the grow calls it inside a process that has joined the
        elastic group, where ``comm_model.profile_width`` (which starts a
        group of its own) cannot run. Ties prefer the wider data axis."""
        k = max(1, int(n_tenants))
        choices: list[MeshChoice] = []
        for n_data, n_model in self.candidate_shapes(n_devices):
            flops = self.step_flops(n_data, n_model)
            wire = comm_model.wire_bytes(self.step_profile(n_data, n_model), axis_size=n_data)
            score_ms = 1000.0 * k * (flops / PEAK_FLOPS
                                     + wire / (comm_model.NVLINK_GBPS * 1e9))
            choices.append(MeshChoice(n_data, n_model, score_ms, {
                "policy": "score", "flops_per_device": flops, "wire_bytes": wire,
                "n_tenants": k}))
        choices.sort(key=lambda c: (c.score_ms, -c.n_data))
        return choices
