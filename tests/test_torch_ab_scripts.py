"""The kernel A/B and probe scripts (``scripts/ab_*.py``,
``scripts/probe_*.py``) on the CPU: the SASS reader of
``ab_common`` counts HMMA instructions per kernel, and each script refuses
to run without a card."""
import importlib
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"

SASS = """
\tcode for sm_90a
\t\tFunction : _ZN2rt18argmax_partial_mmaILi1ELi1EEEvPK13__nv_bfloat16
\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0100*/                   HMMA.16816.F32.BF16 R8, R12, R16, R8 ;
        /*0110*/                   HMMA.16816.F32.BF16 R4, R12, R18, R4 ;
        /*0120*/                   LDSM.16.MT88.4 R16, [R2] ;
\t\tFunction : _ZN2rt12argmax_mergeINS_6FpColsIfEEEEvPKfPKiiPiPf
        /*0000*/                   FFMA R1, R2, R3, R1 ;
"""


def _load(name):
    sys.path.insert(0, str(SCRIPTS))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(str(SCRIPTS))


def test_count_hmma_by_function():
    ab = _load("ab_common")
    assert ab.count_hmma(SASS) == {
        "_ZN2rt18argmax_partial_mmaILi1ELi1EEEvPK13__nv_bfloat16": 2,
        "_ZN2rt12argmax_mergeINS_6FpColsIfEEEEvPKfPKiiPiPf": 0}


@pytest.mark.parametrize("script", ["ab_argmax_verify", "ab_flash_attention",
                                    "ab_decode_attention", "ab_ssd_chunk",
                                    "ab_exit_gate", "probe_exit_gate",
                                    "probe_dense_split",
                                    "probe_paged_attention", "ab_spec_head",
                                    "probe_spec_head",
                                    "probe_predictor_mlp_q",
                                    "ab_predictor_mlp", "probe_ssd_chunk",
                                    "probe_megatick",
                                    "probe_trained_bundle", "probe_replay",
                                    "probe_tp"])
def test_ab_script_refuses_without_a_card(script, monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run")
    mod = _load(script)
    monkeypatch.setattr(sys, "argv", [script, "build/base"])
    assert mod.main() == 1
    assert "python3 scripts/" in capsys.readouterr().out
