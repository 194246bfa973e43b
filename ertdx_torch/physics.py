"""PFLOTRAN forward-model orchestration on the host: a copy of
ertdx/physics.py on the port's data and doe modules.

PFLOTRAN is an external CPU/MPI binary. The reference drives it by writing
a bash script of backgrounded `mpirun` commands and shelling out
(Generate_ERT_utils.py:378-405); here the runner is a bounded
`concurrent.futures` thread pool with per-job timeouts, per-job working
directories (no race on a shared .srv glob, SURVEY.md §5.2), bounded
retries (the reference retries forever, Generate_ERT_utils.py:347), and
structured failure logging. Each run's .srv files are read back by
`data.gather_srv_data`, on the C++ reader.

  * PflotranSimulator: the template line-splicing writer, byte for byte
    the JAX package's: the reference's fixed line indices for the
    `1002023c.in` template (Generate_ERT_utils.py:226-325), plus a
    keyword-anchored mode that survives template drift. It formats
    `np.asarray(parameters, float)`, so callers hand it host rows (numpy;
    the same float64 values as JAX's give the same bytes), never a CUDA
    tensor;
  * ForwardModelRunner: run_simulations (Gaussian ensemble + retry),
    run_simulations_with_params, run_simulations_with_params_single
    (Generate_ERT_utils.py:327-476); the pool finishes in any order and
    its results are keyed by index;
  * SimulationManager: timestamped run dirs, per-sim parameters/data/
    metadata, failed_simulations.json (ERT_Conditional_Diffusion.py:522-564);
  * run_posterior_validation: the reference's one-at-a-time closure loop
    over generated parameter sets (ERT_Conditional_Diffusion.py:656-694).

Host code: numpy and the standard library, no torch.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from datetime import datetime
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .data import SrvFormat, gather_srv_data
from .doe import ParameterSampler


class TimeoutException(Exception):
    """A simulation exceeded its wall-clock budget.

    Reference analogue: SIGALRM handler (ERT_Conditional_Diffusion.py:450,
    519-520); here subprocess timeouts — no signal games, thread-safe."""


# ---------------------------------------------------------------------------
# Input-file writer
# ---------------------------------------------------------------------------

class PflotranSimulator:
    """Writes per-run PFLOTRAN input files from a template.

    mode="lines": exact reference behavior — splice at fixed line numbers
    (only valid for the 1002023c.in template layout,
    Generate_ERT_utils.py:237-325).
    mode="keywords": anchor on PFLOTRAN keywords; robust to templates whose
    line numbering drifts (occurrences are patched in file order:
    1st ARCHIE/POROSITY/PERM block = material 1, 2nd = material 2, ...).
    """

    def __init__(self, template_file: str, output_prefix: str,
                 mode: str = "lines", output_dir: str = "."):
        self.template_file = template_file
        self.output_prefix = output_prefix
        self.mode = mode
        self.output_dir = Path(output_dir)
        self.template_lines = self._read_template()

    def _read_template(self) -> List[str]:
        with open(self.template_file, "r") as f:
            return f.readlines()

    # -- public -------------------------------------------------------------

    def create_input_file(self, parameters: Sequence[float],
                          model_index: int,
                          directory: Optional[Path] = None) -> Path:
        lines = list(self.template_lines)
        if self.mode == "lines":
            self._patch_by_lines(lines, np.asarray(parameters, float))
        else:
            self._patch_by_keywords(lines, np.asarray(parameters, float))
        directory = Path(directory) if directory else self.output_dir
        directory.mkdir(parents=True, exist_ok=True)
        out = directory / f"{self.output_prefix}_{model_index:04d}.in"
        with open(out, "w") as f:
            f.writelines(lines)
        return out

    # reference-compatible alias
    def _create_input_file(self, parameters, model_index):
        return str(self.create_input_file(parameters, model_index))

    # -- fixed-line mode (reference-exact indices) ---------------------------

    def _patch_by_lines(self, lines: List[str], p: np.ndarray) -> None:
        sp = [f"{v:12.4e} \n" for v in p]
        # Material blocks: (archie/porosity slice, perm slice, param offsets)
        for (arch_lo, perm_lo), o in (((79, 87), 0), ((97, 105), 6),
                                      ((115, 123), 12)):
            lines[arch_lo:arch_lo + 4] = [
                f"  ARCHIE_CEMENTATION_EXPONENT {sp[o + 3]}",
                f"  ARCHIE_SATURATION_EXPONENT  {sp[o + 4]}",
                f"  ARCHIE_TORTUOSITY_CONSTANT  {sp[o + 5]}",
                f"  POROSITY {sp[o]}",
            ]
            lines[perm_lo:perm_lo + 3] = [
                f"    PERM_X {sp[o + 1]}",
                f"    PERM_Y {sp[o + 1]}",
                f"    PERM_Z {p[o + 1] * p[o + 2]} \n",
            ]
        # Van Genuchten (Generate_ERT_utils.py:296-318)
        lines[133:136] = [f"    ALPHA {sp[18]}", f"    M {sp[19]}",
                          f"    LIQUID_RESIDUAL_SATURATION {sp[20]}"]
        lines[140:142] = [f"    M {sp[19]}",
                          f"    LIQUID_RESIDUAL_SATURATION {sp[20]}"]
        lines[147:150] = [f"    ALPHA {sp[21]}", f"    M {sp[22]}",
                          f"    LIQUID_RESIDUAL_SATURATION {sp[23]}"]
        lines[154:156] = [f"    M {sp[22]}",
                          f"    LIQUID_RESIDUAL_SATURATION {sp[23]}"]
        # Conductivities (Generate_ERT_utils.py:320-325)
        lines[84] = f"  SURFACE_ELECTRICAL_CONDUCTIVITY {sp[24]}"
        lines[102] = f"  SURFACE_ELECTRICAL_CONDUCTIVITY {sp[25]}"
        lines[120] = f"  SURFACE_ELECTRICAL_CONDUCTIVITY {sp[26]}"
        lines[22] = f"        WATER_CONDUCTIVITY {sp[27]}"

    # -- keyword-anchored mode ------------------------------------------------

    def _patch_by_keywords(self, lines: List[str], p: np.ndarray) -> None:
        sp = [f"{v:12.4e}" for v in p]

        def occurrences(kw: str) -> List[int]:
            # exact-token anchor: a prefix match would confuse 'M' with
            # MODE/MAX_STEPS/MAX_CAPILLARY_PRESSURE etc. (all real
            # PFLOTRAN keywords in the 1002023c.in layout)
            out = []
            for i, ln in enumerate(lines):
                toks = ln.split()
                if toks and toks[0] == kw:
                    out.append(i)
            return out

        def setval(idx: int, kw: str, val: str) -> None:
            indent = lines[idx][: len(lines[idx]) - len(lines[idx].lstrip())]
            lines[idx] = f"{indent}{kw} {val} \n"

        mat_params = [(0, 1, 2, 3, 4, 5), (6, 7, 8, 9, 10, 11),
                      (12, 13, 14, 15, 16, 17)]
        for kw, slot in (("ARCHIE_CEMENTATION_EXPONENT", 3),
                         ("ARCHIE_SATURATION_EXPONENT", 4),
                         ("ARCHIE_TORTUOSITY_CONSTANT", 5),
                         ("POROSITY", 0),
                         ("SURFACE_ELECTRICAL_CONDUCTIVITY", None)):
            occ = occurrences(kw)
            for m, idx in enumerate(occ[:3]):
                if kw == "SURFACE_ELECTRICAL_CONDUCTIVITY":
                    setval(idx, kw, sp[24 + m])
                else:
                    setval(idx, kw, sp[mat_params[m][slot]])
        for m, idx in enumerate(occurrences("PERM_X")[:3]):
            o = mat_params[m]
            setval(idx, "PERM_X", sp[o[1]])
        for m, idx in enumerate(occurrences("PERM_Y")[:3]):
            o = mat_params[m]
            setval(idx, "PERM_Y", sp[o[1]])
        for m, idx in enumerate(occurrences("PERM_Z")[:3]):
            o = mat_params[m]
            setval(idx, "PERM_Z", str(p[o[1]] * p[o[2]]))
        alpha_occ = occurrences("ALPHA")
        m_occ = occurrences("M")
        lrs_occ = occurrences("LIQUID_RESIDUAL_SATURATION")
        vg = [(18, 19, 20), (21, 22, 23)]
        for f_idx, idx in enumerate(alpha_occ[:2]):
            setval(idx, "ALPHA", sp[vg[f_idx][0]])
        # M / residual appear twice per formation (two capillary functions)
        for j, idx in enumerate(m_occ[:4]):
            setval(idx, "M", sp[vg[min(j // 2, 1)][1]])
        for j, idx in enumerate(lrs_occ[:4]):
            setval(idx, "LIQUID_RESIDUAL_SATURATION", sp[vg[min(j // 2, 1)][2]])
        for idx in occurrences("WATER_CONDUCTIVITY")[:1]:
            setval(idx, "WATER_CONDUCTIVITY", sp[27])


# ---------------------------------------------------------------------------
# Run bookkeeping
# ---------------------------------------------------------------------------

class SimulationManager:
    """Run-lifecycle bookkeeping (ERT_Conditional_Diffusion.py:522-564)."""

    def __init__(self, max_simulation_time: float = 3600,
                 base_dir: Optional[str] = None):
        self.max_simulation_time = max_simulation_time
        if base_dir is None:
            ts = datetime.now().strftime("%Y%m%d_%H%M%S")
            base_dir = f"simulation_results_{ts}"
        self.base_output_dir = Path(base_dir)
        self.base_output_dir.mkdir(parents=True, exist_ok=True)
        self.failed_simulations: List[Dict] = []

    def save_simulation_result(self, sim_idx: int, params, data) -> Path:
        sim_dir = self.base_output_dir / f"simulation_{sim_idx:04d}"
        sim_dir.mkdir(exist_ok=True)
        np.save(sim_dir / "parameters.npy", np.asarray(params))
        np.save(sim_dir / "data.npy", np.asarray(data))
        with open(sim_dir / "metadata.json", "w") as f:
            json.dump({"simulation_index": sim_idx,
                       "timestamp": datetime.now().strftime("%Y%m%d_%H%M%S"),
                       "status": "completed"}, f)
        return sim_dir

    def save_failed_simulation(self, sim_idx: int, params,
                               error_msg: str) -> None:
        self.failed_simulations.append({
            "simulation_index": sim_idx,
            "parameters": np.asarray(params).tolist(),
            "error": error_msg,
            "timestamp": datetime.now().strftime("%Y%m%d_%H%M%S"),
        })
        with open(self.base_output_dir / "failed_simulations.json", "w") as f:
            json.dump(self.failed_simulations, f, indent=2)


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RunnerConfig:
    pflotran_path: str = "pflotran/src/pflotran/pflotran"
    mpirun: str = "mpirun"
    np_batch: int = 6           # ranks per sim in batch mode (ref: -np 6)
    np_single: int = 8          # ranks in single mode (ref: -np 8)
    max_concurrent: int = 6     # parallel sims (ref batch_size=6)
    timeout_s: float = 3600.0   # per-sim (ref SIGALRM 3600)
    max_retries: Optional[int] = None  # None = retry forever (ref compat)
    n_surveys: int = 14
    measurements_per_survey: int = 4693
    srv_format: SrvFormat = dataclasses.field(default_factory=SrvFormat)
    isolate_workdirs: bool = True
    use_mpi: bool = True


class ForwardModelRunner:
    """Bounded-concurrency PFLOTRAN fan-out with timeout/retry semantics.

    Reference analogue: Generate_ERT_utils.py:327-476 (bash `&` jobs +
    infinite retry). `expected_len` mirrors the reference's two hard-coded
    survey regimes (37544 = 8 surveys, 65702 = 14 — Generate_ERT_utils.py:
    341, 416) as a configurable product.
    """

    def __init__(self, simulator: PflotranSimulator,
                 parameter_sampler: Optional[ParameterSampler] = None,
                 cfg: Optional[RunnerConfig] = None,
                 workdir: str = ".",
                 manager: Optional[SimulationManager] = None):
        self.simulator = simulator
        self.parameter_sampler = parameter_sampler
        self.cfg = cfg or RunnerConfig()
        self.workdir = Path(workdir)
        self.manager = manager

    @property
    def expected_len(self) -> int:
        return self.cfg.n_surveys * self.cfg.measurements_per_survey

    # -- single sim -----------------------------------------------------------

    def _sim_dir(self, index: int) -> Path:
        if self.cfg.isolate_workdirs:
            d = self.workdir / f"run_{index:04d}"
            d.mkdir(parents=True, exist_ok=True)
            return d
        return self.workdir

    def run_one(self, parameters: np.ndarray, index: int,
                nranks: Optional[int] = None) -> np.ndarray:
        """Write input, launch pflotran, wait, parse .srv outputs."""
        nranks = nranks or self.cfg.np_single
        d = self._sim_dir(index)
        input_file = self.simulator.create_input_file(parameters, index, d)
        if self.cfg.use_mpi:
            cmd = [self.cfg.mpirun, "-np", str(nranks),
                   self.cfg.pflotran_path, "-pflotranin", input_file.name]
        else:
            cmd = [self.cfg.pflotran_path, "-pflotranin", input_file.name]
        try:
            proc = subprocess.run(cmd, cwd=d, capture_output=True,
                                  timeout=self.cfg.timeout_s)
        except subprocess.TimeoutExpired as e:
            raise TimeoutException(
                f"simulation {index} timed out after "
                f"{self.cfg.timeout_s:.0f}s") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"pflotran exited {proc.returncode} for sim {index}: "
                f"{proc.stderr.decode(errors='replace')[-500:]}")
        prefix = f"{self.simulator.output_prefix}_{index:04d}"
        data = gather_srv_data(prefix, str(d), self.cfg.srv_format)
        if data.shape[0] != self.expected_len:
            raise RuntimeError(
                f"sim {index}: got {data.shape[0]} values, expected "
                f"{self.expected_len}")
        return data

    # -- batched with retry -----------------------------------------------------

    def run_simulations_with_params(self, sim_parameters: np.ndarray,
                                    progress: Callable[[str], None] = print
                                    ):
        """Run all rows of (N, 29) params; retry failures; returns
        (params, data (N, expected_len)). Reference:
        Generate_ERT_utils.py:407-442."""
        sim_parameters = np.asarray(sim_parameters)
        n = len(sim_parameters)
        data = np.zeros((n, self.expected_len))
        failed = np.ones(n, dtype=bool)
        attempt = 0
        while failed.any():
            attempt += 1
            if (self.cfg.max_retries is not None
                    and attempt > self.cfg.max_retries + 1):
                break
            idxs = np.nonzero(failed)[0]
            if attempt > 1:
                progress(f"Retrying failed simulations. Attempt {attempt}; "
                         f"indices {idxs.tolist()}")
            results = self._run_pool(idxs, sim_parameters)
            for i, res in results.items():
                if isinstance(res, np.ndarray):
                    data[i] = res
                    failed[i] = False
                    if self.manager:
                        self.manager.save_simulation_result(
                            i, sim_parameters[i], res)
                else:
                    progress(f"WARNING: Simulation {i + 1}/{n} failed and "
                             f"will be retried ({res})")
                    if self.manager:
                        self.manager.save_failed_simulation(
                            i, sim_parameters[i], str(res))
            progress(f"Progress: {int(n - failed.sum())}/{n} simulations "
                     f"completed successfully")
        if failed.any():
            raise RuntimeError(
                f"simulations {np.nonzero(failed)[0].tolist()} failed after "
                f"{self.cfg.max_retries} retries")
        return sim_parameters, data

    def run_simulations(self, pmean, psdev, n_models: int,
                        progress: Callable[[str], None] = print):
        """Sample a Gaussian ensemble then run it. On retries, FAILED rows
        are resampled (the reference resamples the whole design and reruns
        only failed indices, Generate_ERT_utils.py:347-356 — equivalent
        marginal behavior, less waste). Reference survey regime: 8 surveys.
        """
        if self.parameter_sampler is None:
            raise ValueError("run_simulations needs a parameter_sampler")
        params = self.parameter_sampler.build_mod_in(pmean, psdev, n_models)
        n = n_models
        data = np.zeros((n, self.expected_len))
        failed = np.ones(n, dtype=bool)
        attempt = 0
        while failed.any():
            attempt += 1
            if (self.cfg.max_retries is not None
                    and attempt > self.cfg.max_retries + 1):
                raise RuntimeError(
                    f"{int(failed.sum())} simulations still failing after "
                    f"{self.cfg.max_retries} retries")
            idxs = np.nonzero(failed)[0]
            if attempt > 1:
                fresh = self.parameter_sampler.build_mod_in(
                    pmean, psdev, n_models)
                params[idxs] = fresh[idxs]
            results = self._run_pool(idxs, params)
            for i, res in results.items():
                if isinstance(res, np.ndarray):
                    data[i] = res
                    failed[i] = False
                    if self.manager:          # same bookkeeping as the
                        self.manager.save_simulation_result(   # params path
                            i, params[i], res)
                else:
                    progress(f"WARNING: Simulation {i + 1}/{n} failed "
                             f"({res})")
                    if self.manager:
                        self.manager.save_failed_simulation(
                            i, params[i], str(res))
            progress(f"Progress: {int(n - failed.sum())}/{n} completed")
        return params, data

    def run_simulations_with_params_single(self, sim_parameters: np.ndarray,
                                           model_index: int) -> np.ndarray:
        """One simulation with np_single ranks; returns the flat data vector.
        Reference: Generate_ERT_utils.py:444-476."""
        return self.run_one(np.asarray(sim_parameters), model_index,
                            nranks=self.cfg.np_single)

    # -- pool ----------------------------------------------------------------

    def _run_pool(self, indices: np.ndarray, parameters: np.ndarray
                  ) -> Dict[int, object]:
        out: Dict[int, object] = {}
        with ThreadPoolExecutor(self.cfg.max_concurrent) as pool:
            futs = {pool.submit(self.run_one, parameters[i], int(i),
                                self.cfg.np_batch): int(i)
                    for i in indices}
            for fut in as_completed(futs):
                i = futs[fut]
                try:
                    out[i] = fut.result()
                except Exception as e:  # noqa: BLE001 — recorded + retried
                    out[i] = e
        return out


def run_posterior_validation(runner: ForwardModelRunner,
                             manager: SimulationManager,
                             param_sets: np.ndarray,
                             n_surveys: int = 14,
                             progress: Callable[[str], None] = print):
    """Drive one-sim-at-a-time validation of generated posterior parameter
    sets with timeout handling and bookkeeping.

    Reference: the inline closure loop (ERT_Conditional_Diffusion.py:656-694).
    Returns indices of completed sims.
    """
    completed = []
    start = time.time()
    total = len(param_sets)
    for i, params in enumerate(param_sets):
        progress(f"Starting simulation {i + 1}/{total}")
        t0 = time.time()
        try:
            flat = runner.run_simulations_with_params_single(params, i)
            # save the flat vector — the same shape the pool path saves
            # (np.vstack produced (1, L) here vs (L,) there, and the
            # most-common-shape re-ingest filter would silently discard
            # whichever population was the minority)
            manager.save_simulation_result(i, params, np.asarray(flat))
            completed.append(i)
            elapsed = time.time() - start
            eta = elapsed / (i + 1) * (total - i - 1)
            progress(f"Simulation {i + 1} completed in "
                     f"{time.time() - t0:.2f}s; ETA {eta / 3600:.2f}h; "
                     f"progress {len(completed)}/{total}")
        except TimeoutException:
            progress(f"Simulation {i + 1} timed out after "
                     f"{runner.cfg.timeout_s:.0f} seconds")
            manager.save_failed_simulation(i, params, "Timeout")
        except Exception as e:  # noqa: BLE001 — mirror reference: log+continue
            progress(f"Error in simulation {i + 1}: {e}")
            manager.save_failed_simulation(i, params, str(e))
    return completed
