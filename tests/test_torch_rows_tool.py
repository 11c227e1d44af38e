"""``tools/rows.py``, the script that times the port's kernel rows on the
card, checked here where its sources are: every variant's text edits find
what they replace exactly once in the current ``csrc`` (the kernels have no
measurement switch, so a variant is an edited copy of their text), the
SASS reader finds a loop's hot path around a slow path, and a kernel's
resources line reads its kernel, fold, step and draw source from its
symbol.
"""

import importlib.util
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "montecarlo_tpu_torch" / "csrc"


def _tool():
    spec = importlib.util.spec_from_file_location(
        "rows_tool", REPO / "tools" / "rows.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ROWS = _tool()
VARIANTS = [(s, v) for s, rs in sorted(ROWS.ROW_SETS.items())
            for v in rs.variants]


@pytest.mark.parametrize("row_set,variant", VARIANTS)
def test_variant_edits_find_their_text(row_set, variant, tmp_path):
    edits = ROWS.ROW_SETS[row_set].variants[variant]
    out = tmp_path / "csrc"
    shutil.copytree(CSRC, out)
    ROWS.apply_edits(out, edits, variant)
    for fname, old, new in edits:
        assert new in (out / fname).read_text(), (fname, old[:40])
    changed = {f for f, _, _ in edits}
    for path in CSRC.iterdir():
        same = (out / path.name).read_bytes() == path.read_bytes()
        assert same == (path.name not in changed), path.name


def test_variant_edits_refuse_missing_text(tmp_path):
    out = tmp_path / "csrc"
    shutil.copytree(CSRC, out)
    fname, old, new = ROWS.SLV_SOBOL_VARIANTS["key per normal"][0]
    (out / fname).write_text((out / fname).read_text().replace(old, ""))
    with pytest.raises(RuntimeError, match="key per normal"):
        ROWS.apply_edits(out, [(fname, old, new)], "key per normal")


SASS = """
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   IADD3 R2, R2, 0x1, RZ ;
        /*0020*/                   FMUL R3, R3, R4 ;
        /*0030*/               @P0 BRA 0x70 ;
        /*0040*/                   MOV R8, R3 ;
        /*0050*/                   CALL.REL.NOINC 0x200 ;
        /*0060*/                   MOV R3, R8 ;
        /*0070*/                   FADD R3, R3, R5 ;
        /*0080*/               @P1 BRA 0xa0 ;
        /*0090*/                   FADD R3, R3, R6 ;
        /*00a0*/                   ISETP.GE.AND P2, PT, R2, R7, PT ;
        /*00b0*/              @!P2 BRA 0x10 ;
        /*00c0*/                   EXIT ;
"""


def test_sass_hot_path_skips_the_slow_path():
    ins = ROWS.parse_sass(SASS)
    assert len(ins) == 13
    loop = ROWS.hottest_loop(ins)
    assert [a for a, *_ in loop] == list(range(0x10, 0xc0, 0x10))
    hot = [a for a, *_ in ROWS.hot_path(ins)]
    # the CALL's three instructions are skipped; the other branch falls
    # through
    assert hot == [0x10, 0x20, 0x30, 0x70, 0x80, 0x90, 0xa0, 0xb0]


# A loop whose branch leaves for a block placed after the loop and comes
# back with an unconditional branch.
SASS_OUT_OF_LINE = """
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   IADD3 R2, R2, 0x1, RZ ;
        /*0020*/                   FADD R3, R3, R6 ;
        /*0030*/                   BRA 0x90 ;
        /*0040*/                   FADD R3, R3, R5 ;
        /*0050*/                   FADD R3, R3, R6 ;
        /*0060*/                   ISETP.GE.AND P2, PT, R2, R7, PT ;
        /*0070*/              @!P2 BRA 0x10 ;
        /*0080*/                   EXIT ;
        /*0090*/                   FMUL R3, R3, R4 ;
        /*00a0*/                   BRA 0x40 ;
"""


def test_sass_hot_path_follows_a_block_after_the_loop():
    ins = ROWS.parse_sass(SASS_OUT_OF_LINE)
    hot = [a for a, *_ in ROWS.hot_path(ins)]
    assert hot == [0x10, 0x20, 0x30, 0x90, 0xa0, 0x40, 0x50, 0x60, 0x70]


def test_sass_hot_path_refuses_a_walk_off_the_end():
    ins = ROWS.parse_sass(SASS_OUT_OF_LINE.replace("BRA 0x40", "NOP"))
    with pytest.raises(ValueError, match="no hot path"):
        ROWS.hot_path(ins)


_STATE_K2 = ("_ZN3mcf12_GLOBAL__N_112state_kernelINS0_9StateProcIN2mc7DccStep"
             "ILi{a}EEELi{a}EEENS_{draws}ENS_13StoreTerminalEEEvNT_6Leaves"
             "Elijjjj")


@pytest.mark.parametrize("name,steps", [
    (_STATE_K2.format(a=8, draws="13ThreefryDrawsILb0EE"), 1),
    (_STATE_K2.format(a=8, draws="13ThreefryDrawsILb1EE"), 1),
    (_STATE_K2.format(a=5, draws="13ThreefryDrawsILb0EE"), 2),
    (_STATE_K2.format(a=8, draws="10SobolDrawsE"), 2),
    (_STATE_K2.format(a=8, draws="13ThreefryDrawsILb0EE").replace(
        "state_kernel", "fused_kernel"), 2),
    ("_ZN3mcf12_GLOBAL__N_120rbergomi_ring_kernelILi4ELi3EEEvPKf", 4)])
def test_stage_steps_reads_the_symbol(name, steps):
    """A pass of the time loop: a step in CCC's and DCC's by-value kernels
    at an even A under Threefry draws, K in K6's ring, else a step pair."""
    assert ROWS.stage_steps(name) == steps
    assert ROWS.passes(name, 10) == -(-10 // steps)


# K4's and K2's symbols as cuobjdump names them (the anonymous namespace's
# tag is the unit's).
_RATES = "NS_47_GLOBAL__N__1c5e0394_14_fused_rates_cu_6f6817a28RateProcIN2mc"
_TB_K4 = ("NS_56_GLOBAL__N__bd7da0ec_23_fused_term_basket_k4_cu_fa681790"
          "9StateProcIN2mc14TermBasketStepILi{a}EEELi{a}EEE")
_K4 = ("_ZN3mcf23fused_functional_kernelI{proc}NS_{draws}E{fold}EEvPKfilijjj"
       "T0_NS_14FunctionalSpecEPf")


@pytest.mark.parametrize("name,tag", [
    (_K4.format(proc=_RATES + "11VasicekStepELi1EEE",
                draws="13ThreefryDrawsILb0EE", fold="NS_9FixedFoldIJLi8EEEE"),
     "K4 fixed {8} VasicekStep D=1 plain"),
    (_K4.format(proc=_RATES + "8G2ppStepELi2EEE",
                draws="13ThreefryDrawsILb1EE", fold="NS_8SpecFoldE"),
     "K4 generic G2ppStep D=2 antithetic"),
    (_K4.format(proc=_TB_K4.format(a=5), draws="13ThreefryDrawsILb0EE",
                fold="NS_9FixedFoldIJLi0EEEE"),
     "K4 fixed {0} TermBasketStep A=5 plain"),
    (_K4.format(proc=_TB_K4.format(a=8), draws="10SobolDrawsE",
                fold="NS_8SpecFoldE"),
     "K4 generic TermBasketStep A=8 sobol"),
    ("_ZN3mcf12fused_kernelI" + _RATES + "11VasicekStepELi1EEENS_13"
     "ThreefryDrawsILb0EEENS_13StoreTerminalEEEvPKfilijjjT0_T1_",
     "K2 VasicekStep D=1 plain"),
    (_STATE_K2.format(a=8, draws="13ThreefryDrawsILb0EE"),
     "K2 DccStep A=8 plain"),
    (_STATE_K2.format(a=3, draws="13ThreefryDrawsILb1EE").replace(
        "13StoreTerminal", "10RowMoments"),
     "K3 DccStep A=3 antithetic")])
def test_kernel_tag_reads_the_symbol(name, tag):
    """A kernel's tag in the resources lines: K2, K3 or K4 with its fold
    (fixed and its codes, or generic), the step with its asset count A or
    its draws a step D, and the draw source."""
    assert ROWS._kernel_tag(name) == tag


def test_grid_rows_reads_either_launch_keying():
    """The snapshot rows' digest view: a grid's rows in maturity order from
    one launch's keys (``m<step>``, ``terminal``) and from grouped
    launches' (``m<step> (launch g)``, the last launch's terminal), so a
    checkout of either kind digests the same rows."""
    one = {"terminal": "T", "m63": "c", "m21": "a", "m42": "b"}
    grouped = {"terminal (launch 0)": "x", "m21 (launch 0)": "a",
               "m42 (launch 0)": "b", "terminal (launch 1)": "T",
               "m63 (launch 1)": "c"}
    want = {0: "a", 1: "b", 2: "c", 3: "T"}
    assert ROWS.grid_rows(one) == ROWS.grid_rows(grouped) == want
    snap = ("_ZN3mcf21fused_snapshot_kernelINS_12_GLOBAL__N_17GbmProcENS_"
            "13ThreefryDrawsILb0EEEEEvPKfilijjjT0_NS_12SnapshotPlanEPf")
    assert ROWS._kernel_tag(snap).startswith("K4 snapshot _ZN3mcf21")
