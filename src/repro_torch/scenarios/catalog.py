"""The registered scenario catalog: the axes the paper's evaluation varies.

The reference's ``repro.scenarios.catalog``, entry for entry and field for
field (27 scenarios):

* ``credit/overlap-N``: the overlap sweep 32 → 2048 on the UCI-credit-like
  tabular task (Fig. 6/7's x-axis);
* ``credit/feature-skew`` (18 against 5 of 23 features) and
  ``credit/label-noise`` (25 % label flips);
* ``credit/parties-{4,8}``: 4- and 8-party tabular splits;
* ``hard/overlap-{32,64}``: the hardened limited-overlap task
  (``make_cluster_tabular``), where one-shot VFL beats iterative VFL;
* ``hard/overlap-{32,64}-eq``: the same at a fixed 64-row aligned capacity,
  the real overlap first and cyclic duplicates after, under a validity mask;
* ``edge/full-overlap``: every training row aligned, empty private pools;
* ``image/halves`` and ``image/patch-4``: images split into vertical
  halves (paper §5.1) or a 2×2 patch grid (4 parties);
* ``fault/*``: one 4-party hard condition under nine fault treatments
  (dropout at four stages, a half-budget straggler, DP-noised uploads at
  two σ, a representation-only party) and its fault-free twin
  ``fault/none``; the runners apply its ``fault`` (``core.faults``).
"""
from __future__ import annotations

from repro_torch.scenarios.faults import FaultSpec
from repro_torch.scenarios.registry import ScenarioSpec, register

OVERLAP_SWEEP = (32, 64, 128, 256, 512, 1024, 2048)

for _n_o in OVERLAP_SWEEP:
    register(ScenarioSpec(
        name=f"credit/overlap-{_n_o}",
        modality="tabular",
        generator="tabular_credit",
        overlap=_n_o,
        num_samples=max(1500, 3 * _n_o),
        feature_sizes=(10, 13),
        rep_dim=16,
        budgets=(("client_epochs", 8), ("server_epochs", 30),
                 ("iterations", 400)),
        tags=("sweep", "tabular") + (("frontier",) if _n_o in (128, 512)
                                     else ()),
        description=f"UCI-credit-like tabular VFL, N_o={_n_o}",
    ))

register(ScenarioSpec(
    name="credit/feature-skew",
    modality="tabular",
    generator="tabular_credit",
    overlap=128,
    num_samples=1500,
    feature_sizes=(18, 5),
    rep_dim=16,
    budgets=(("client_epochs", 8), ("server_epochs", 30),
             ("iterations", 400)),
    tags=("skew", "tabular"),
    description="information-skewed parties: 18 vs 5 of 23 features",
))

register(ScenarioSpec(
    name="credit/label-noise",
    modality="tabular",
    generator="tabular_credit",
    overlap=128,
    num_samples=1500,
    gen_params=(("label_noise", 0.25),),
    feature_sizes=(10, 13),
    rep_dim=16,
    budgets=(("client_epochs", 8), ("server_epochs", 30),
             ("iterations", 400)),
    tags=("noise", "tabular"),
    description="25% label flips on the server's overlap labels",
))

for _k, _d in ((4, 32), (8, 40)):
    register(ScenarioSpec(
        name=f"credit/parties-{_k}",
        modality="tabular",
        generator="tabular_credit",
        overlap=128,
        num_samples=1800,
        num_parties=_k,
        gen_params=(("num_features", _d),),
        rep_dim=8,
        hidden=(32,),
        budgets=(("client_epochs", 8), ("server_epochs", 30),
                 ("iterations", 400)),
        tags=("parties", "tabular"),
        description=f"{_k}-party tabular split, {_d} features evenly",
    ))

for _n_o in (32, 64):
    register(ScenarioSpec(
        name=f"hard/overlap-{_n_o}",
        modality="tabular",
        generator="cluster_tabular",
        overlap=_n_o,
        num_samples=3000,
        gen_params=(("num_informative", 24), ("num_nuisance", 16),
                    ("num_clusters", 12), ("cluster_std", 0.3),
                    ("nuisance_std", 2.0), ("label_noise", 0.15)),
        feature_sizes=(20, 20),
        rep_dim=16,
        ssl_params=(("confidence_threshold", 0.8),),
        budgets=(("client_epochs", 80), ("server_epochs", 40),
                 ("iterations", 400)),
        tags=("hard", "tabular", "frontier", "smoke"),
        smoke_samples=3000,
        smoke_overlap=_n_o,
        description=("hardened limited-overlap task: wide clusters, "
                     "nuisance dims, label flips"),
    ))

for _n_o in (32, 64):
    register(ScenarioSpec(
        # equal-shape variant of the hard family: the aligned block is
        # always materialized at the family capacity (64 rows: real overlap
        # first, cyclic duplicates after, validity mask alongside) and the
        # first 64 pool rows are reserved regardless of N_o, so both members
        # share one shape and one pool
        name=f"hard/overlap-{_n_o}-eq",
        modality="tabular",
        generator="cluster_tabular",
        overlap=_n_o,
        overlap_capacity=64,
        num_samples=3000,
        gen_params=(("num_informative", 24), ("num_nuisance", 16),
                    ("num_clusters", 12), ("cluster_std", 0.3),
                    ("nuisance_std", 2.0), ("label_noise", 0.15)),
        feature_sizes=(20, 20),
        rep_dim=16,
        ssl_params=(("confidence_threshold", 0.8),),
        budgets=(("client_epochs", 80), ("server_epochs", 40),
                 ("iterations", 400)),
        tags=("hard", "tabular", "eq"),
        smoke_samples=3000,
        smoke_overlap=64,   # == capacity: smoke keeps the padded shape equal
        description=(f"hard task at fixed 64-row aligned capacity, N_o={_n_o} "
                     "real rows + cyclic padding under a validity mask"),
    ))

register(ScenarioSpec(
    # full-overlap edge: every training row is aligned, the per-party
    # private pools are EMPTY — the engine must schedule zero-width
    # unlabeled batches (l_u ≡ 0) instead of NaN-ing the SSL loss
    # (regression scenario for the n_unlabeled == 0 guard)
    name="edge/full-overlap",
    modality="tabular",
    generator="tabular_credit",
    overlap=800,                  # == all non-test rows of 1000 @ 20% test
    num_samples=1000,
    feature_sizes=(10, 13),
    rep_dim=16,
    budgets=(("client_epochs", 4), ("server_epochs", 20),
             ("iterations", 200)),
    tags=("edge", "tabular"),
    smoke_overlap=800,            # smoke() must keep the pools empty
    smoke_samples=1000,
    description="full overlap: N_o = all rows, empty private pools",
))

def _fault_member(suffix: str, fault, description: str) -> ScenarioSpec:
    # ONE experimental condition, nine fault treatments: every member is
    # identical except ``fault``, so each degradation is measured against
    # fault/none on the same data
    return ScenarioSpec(
        name=f"fault/{suffix}",
        modality="tabular",
        generator="cluster_tabular",
        overlap=32,
        num_samples=3000,
        num_parties=4,
        gen_params=(("num_informative", 24), ("num_nuisance", 16),
                    ("num_clusters", 12), ("cluster_std", 0.3),
                    ("nuisance_std", 2.0), ("label_noise", 0.15)),
        feature_sizes=(10, 10, 10, 10),
        rep_dim=16,
        ssl_params=(("confidence_threshold", 0.8),),
        fault=fault,
        budgets=(("client_epochs", 20), ("server_epochs", 30),
                 ("iterations", 200)),
        tags=("fault", "tabular", "frontier"),
        smoke_samples=3000,
        smoke_overlap=32,
        description=description,
    )


register(_fault_member(
    "none", None,
    "fault-free twin of the fault/* family — the degradation baseline"))
for _stage in ("pre-upload", "pre-ssl", "post-ssl", "pre-round2"):
    register(_fault_member(
        f"dropout-{_stage}",
        FaultSpec(kind="dropout", party=1, stage=_stage.replace("-", "_")),
        f"party 1 of 4 drops out {_stage.replace('-', ' ')}: one-shot "
        "reconstructs H_o via Eq. 10, iterative stalls and retries"))
register(_fault_member(
    "straggler-half",
    FaultSpec(kind="straggler", party=1, epoch_fraction=0.5),
    "party 1 completes only half its local SSL epoch budget"))
for _sigma in (0.1, 0.5):
    register(_fault_member(
        f"dp-sigma-{_sigma}",
        FaultSpec(kind="dp_upload", party=1, dp_sigma=_sigma),
        f"party 1 noises every upload at sigma={_sigma}x std "
        "(bytes unchanged — privacy costs accuracy, not communication)"))
register(_fault_member(
    "rep-only",
    FaultSpec(kind="representation_only", party=1),
    "APC-style passive party: contributes representations, never "
    "runs local SSL (frozen extractor)"))


register(ScenarioSpec(
    name="image/halves",
    modality="image",
    generator="image_classification",
    overlap=96,
    num_samples=500,
    gen_params=(("num_classes", 4), ("image_size", 16),
                ("template_strength", 3.0)),
    rep_dim=32,
    widths=(8, 16),
    blocks_per_stage=1,
    ssl_params=(("max_shift", 2), ("cutout_size", 4)),
    budgets=(("client_epochs", 3), ("server_epochs", 10),
             ("iterations", 60)),
    tags=("image",),
    smoke_samples=300,
    smoke_overlap=48,
    description="paper §5.1 layout: images split into vertical halves",
))

register(ScenarioSpec(
    name="image/patch-4",
    modality="image",
    generator="image_classification",
    overlap=96,
    num_samples=500,
    num_parties=4,
    image_grid=(2, 2),
    gen_params=(("num_classes", 4), ("image_size", 16),
                ("template_strength", 3.0)),
    rep_dim=32,
    widths=(8, 16),
    blocks_per_stage=1,
    ssl_params=(("max_shift", 2), ("cutout_size", 4)),
    budgets=(("client_epochs", 3), ("server_epochs", 10),
             ("iterations", 60)),
    tags=("image", "patch"),
    smoke_samples=300,
    smoke_overlap=48,
    description="image-patch modality: 2x2 grid, one quadrant per party",
))
