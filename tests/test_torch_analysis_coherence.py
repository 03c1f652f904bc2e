"""The port's coherence checker (`repro_torch.analysis.coherence`):
per-rule fixtures (positive and negative), waiver semantics, the
clean-source gate over the port's pool, session and server, the
committed golden manifest, drift detection, and the seeded-mutation
harness. The counterparts of tests/test_analysis_coherence.py; the
folded-cache rule has no pair to check until the port's sharded slab,
so its fixtures install one."""
import io
import json
import textwrap

import pytest

import repro_torch.analysis.coherence as coh

POOL_PASS = "class SessionPool:\n    pass\n"
SESSION_PASS = "class SaathSession:\n    pass\n"
SERVE_PASS = "class CoflowServer:\n    pass\n"


def findings_of(pool="", session="", serve=""):
    sources = {
        "api/pool.py": textwrap.dedent(pool) or POOL_PASS,
        "api/session.py": textwrap.dedent(session) or SESSION_PASS,
        "launch/serve.py": textwrap.dedent(serve) or SERVE_PASS,
    }
    return coh.check_protocol(sources)


def rules_of(**kw):
    return {f.rule for f in findings_of(**kw)}


# ---- coh-dirty-on-write --------------------------------------------------

def test_membership_write_without_dirty_flag():
    assert coh.R_DIRTY in rules_of(session="""
        class SaathSession:
            def submit(self, cf):
                self._live[cf.handle] = cf
                return cf.handle
    """)


def test_membership_write_with_dirty_flag_is_clean():
    assert coh.R_DIRTY not in rules_of(session="""
        class SaathSession:
            def submit(self, cf):
                self._live[cf.handle] = cf
                self._tb_dirty = True
                return cf.handle
    """)


def test_dirty_flag_must_hold_on_all_paths():
    # flag set on only one branch: the other exit leaks a silent
    # membership change
    assert coh.R_DIRTY in rules_of(session="""
        class SaathSession:
            def submit(self, cf, fast):
                self._live[cf.handle] = cf
                if fast:
                    self._tb_dirty = True
                return cf.handle
    """)


def test_entry_write_requires_state_dirty():
    src = """
        class SaathSession:
            def complete(self, e, now):
                e.finished = True
                e.cct = now{flag}
    """
    assert coh.R_DIRTY in rules_of(session=src.format(flag=""))
    assert coh.R_DIRTY not in rules_of(session=src.format(
        flag="\n                self._state_dirty = True"))


def test_legal_sync_writers_are_exempt():
    # _sync_row copies FROM the authoritative device row; dirtying
    # would be wrong, and the checker knows it
    assert coh.R_DIRTY not in rules_of(pool="""
        class SessionPool:
            def _sync_row(self, e, host):
                e.finished = host.finished
    """)


# ---- coh-sync-before-mirror ----------------------------------------------

def test_mirror_read_without_sync():
    assert coh.R_SYNC in rules_of(pool="""
        class SessionPool:
            def _sync_ctl(self):
                self._ctl = None

            def peek(self):
                return self._ticks
    """)


def test_mirror_read_after_sync_is_clean():
    assert coh.R_SYNC not in rules_of(pool="""
        class SessionPool:
            def _sync_ctl(self):
                self._ctl = None

            def peek(self):
                self._sync_ctl()
                return self._ticks
    """)


def test_sync_requirement_propagates_through_helpers():
    # the unsynced access is in a private helper; the finding lands on
    # the public entry that reaches it
    fs = findings_of(pool="""
        class SessionPool:
            def _sync_ctl(self):
                self._ctl = None

            def _probe(self):
                return self._fin.any()

            def peek(self):
                return self._probe()
    """)
    hits = [f for f in fs if f.rule == coh.R_SYNC]
    assert hits and "SessionPool.peek" in hits[0].msg
    assert "_probe" in hits[0].msg


def test_sync_via_providing_callee_is_clean():
    # a callee that syncs on every exit dominates the later access
    assert coh.R_SYNC not in rules_of(pool="""
        class SessionPool:
            def _sync_ctl(self):
                self._ctl = None

            def _refresh(self):
                self._sync_ctl()
                return True

            def peek(self):
                self._refresh()
                return self._ticks
    """)


def test_rearming_the_ctl_revokes_the_sync_fact():
    # sync, then an async dispatch parks a NEW ctl: the mirror is
    # stale again and the read must be flagged
    assert coh.R_SYNC in rules_of(pool="""
        class SessionPool:
            def _sync_ctl(self):
                self._ctl = None

            def peek(self, work):
                self._sync_ctl()
                self._ctl = work
                return self._ticks
    """)


# ---- coh-stale-folded-cache ----------------------------------------------

@pytest.fixture
def folded(monkeypatch):
    """The sharded slab's cache pairs (not ported yet) and their
    tracked names, installed for the rule's fixtures."""
    monkeypatch.setattr(coh, "CACHE_OF",
                        {"_tb": "_tb_disp", "_ep_stack": "_ep_disp"})
    pool = dict(coh.PROTOCOL["SessionPool"], _tb_disp="folded _tb",
                _ep_disp="folded _ep_stack")
    monkeypatch.setitem(coh.PROTOCOL, "SessionPool", pool)


def test_the_port_has_no_folded_cache_yet():
    assert coh.CACHE_OF == {}
    assert coh.R_CACHE not in rules_of(pool="""
        class SessionPool:
            def _rebuild(self, tb):
                self._tb = tb
    """)


def test_slab_rewrite_without_cache_invalidation(folded):
    assert coh.R_CACHE in rules_of(pool="""
        class SessionPool:
            def _rebuild(self, tb):
                self._tb = tb
    """)


def test_slab_rewrite_with_cache_invalidation_is_clean(folded):
    assert coh.R_CACHE not in rules_of(pool="""
        class SessionPool:
            def _rebuild(self, tb):
                self._tb = tb
                self._tb_disp = None
    """)


def test_setting_slab_to_none_is_an_invalidation_not_a_rewrite(folded):
    assert coh.R_CACHE not in rules_of(pool="""
        class SessionPool:
            def drop(self):
                self._ep_stack = None
    """)


# ---- coh-ctl-consume-once ------------------------------------------------

def test_only_the_blessed_pair_may_touch_the_handle():
    assert coh.R_HANDLE in rules_of(pool="""
        class SessionPool:
            def steal(self):
                return self._ctl
    """)


def test_consumer_must_reset_the_handle():
    assert coh.R_HANDLE in rules_of(pool="""
        class SessionPool:
            def _sync_ctl(self):
                tick, fin = self._ctl
                return tick, fin
    """)
    assert coh.R_HANDLE not in rules_of(pool="""
        class SessionPool:
            def _sync_ctl(self):
                tick, fin = self._ctl
                self._ctl = None
                return tick, fin
    """)


# ---- coh-unaccounted-transfer --------------------------------------------

def test_public_transfer_outside_accounted_frame():
    assert coh.R_IO in rules_of(pool="""
        import numpy as np

        class SessionPool:
            def host_view(self):
                return np.asarray(self._state)
    """)


@pytest.mark.parametrize("pull", ["self._state.tick.cpu()",
                                  "self._download(self._state)",
                                  "self._eng.host_to_device(x, d)",
                                  "to_device(self._tb, d)"])
def test_port_transfer_leaves_outside_accounted_frame(pull):
    assert coh.R_IO in rules_of(pool=f"""
        class SessionPool:
            def host_view(self, x=None, d=None):
                return {pull}
    """)


def test_accounted_frame_is_clean():
    assert coh.R_IO not in rules_of(pool="""
        import numpy as np

        class SessionPool:
            @_io_accounted
            def host_view(self):
                return np.asarray(self._state)
    """)


def test_transfer_reached_through_helper_is_flagged():
    fs = findings_of(pool="""
        class SessionPool:
            def _pull(self, rows):
                return self._je.gather_rows(self._tb, rows)

            def poll(self):
                return self._pull([0])
    """)
    hits = [f for f in fs if f.rule == coh.R_IO]
    assert hits and "gather_rows" in hits[0].msg


# ---- coh-fresh-index -----------------------------------------------------

def test_new_done_without_fresh_update():
    assert coh.R_FRESH in rules_of(pool="""
        class SessionPool:
            def mark(self, s):
                s._new_done = True
    """)


def test_new_done_with_fresh_update_is_clean():
    assert coh.R_FRESH not in rules_of(pool="""
        class SessionPool:
            def mark(self, s):
                s._new_done = True
                self._fresh.add(s)
    """)


# ---- coh-harvest-before-read ---------------------------------------------

def test_pending_read_without_harvest():
    assert coh.R_HARVEST in rules_of(serve="""
        class CoflowServer:
            def poll(self, tenant):
                return self._pending[tenant]
    """)


def test_pending_read_after_harvest_is_clean():
    assert coh.R_HARVEST not in rules_of(serve="""
        class CoflowServer:
            def poll(self, tenant):
                self._harvest(tenant)
                return self._pending[tenant]
    """)


def test_pending_write_needs_no_harvest():
    assert coh.R_HARVEST not in rules_of(serve="""
        class CoflowServer:
            def register(self, tenant):
                self._pending[tenant] = []
    """)


# ---- waivers -------------------------------------------------------------

def test_waiver_silences_and_its_removal_reinstates(monkeypatch):
    # CoflowServer.stats reads _pending without a harvest by design;
    # dropping the waiver must resurface the finding on the real tree
    assert coh.check_protocol() == []
    monkeypatch.delitem(coh.WAIVERS,
                        ("CoflowServer.stats", coh.R_HARVEST))
    fs = coh.check_protocol()
    assert [f for f in fs if f.rule == coh.R_HARVEST
            and "CoflowServer.stats" in f.msg]


# ---- the real tree: clean gate + committed manifest ----------------------

def test_repo_serving_plane_is_coherence_clean():
    fs = coh.check_protocol()
    assert not fs, "\n".join(str(f) for f in fs)


def test_committed_manifest_matches_extraction():
    path = coh.default_manifest_path()
    assert path.exists(), (
        f"no {path} -- run `python -m repro_torch.analysis.coherence "
        f"--update` and commit it")
    problems = coh.check_manifest(json.loads(path.read_text()))
    assert not problems, "\n".join(problems)


def test_manifest_covers_the_async_protocol_core():
    manifest = json.loads(coh.default_manifest_path().read_text())
    m = manifest["methods"]
    sync = m["SessionPool._sync_ctl"]
    assert sync["provides_sync"] and sync["accounted"]
    assert "_ctl" in sync["invalidates"]
    disp = m["SessionPool._dispatch_async"]
    assert "_ctl" in disp["writes"] and not disp["provides_sync"]


# ---- drift detection -----------------------------------------------------

POOL_V1 = """
    class SessionPool:
        def _sync_ctl(self):
            self._ctl = None

        def peek(self):
            self._sync_ctl()
            return self._ticks
"""

POOL_V2 = """
    class SessionPool:
        def _sync_ctl(self):
            self._ctl = None

        def peek(self):
            self._sync_ctl()
            self._fin = None
            return self._ticks

        def extra(self):
            return 1
"""


def _sources(pool_src):
    return {"api/pool.py": textwrap.dedent(pool_src),
            "api/session.py": SESSION_PASS,
            "launch/serve.py": SERVE_PASS}


def test_drift_is_reported_as_a_structured_diff():
    manifest = coh.build_manifest(_sources(POOL_V1))
    problems = coh.check_manifest(manifest, _sources(POOL_V2))
    text = "\n".join(problems)
    assert "SessionPool.extra: new method" in text
    assert "SessionPool.peek: effect drift" in text
    assert "+ invalidate: _fin" in text
    # and the same manifest against the same sources is quiet
    assert coh.check_manifest(manifest, _sources(POOL_V1)) == []


def test_removed_method_is_reported():
    manifest = coh.build_manifest(_sources(POOL_V2))
    problems = coh.check_manifest(manifest, _sources(POOL_V1))
    assert any("SessionPool.extra" in p and "no longer" in p
               for p in problems)


# ---- the seeded-mutation harness -----------------------------------------

def test_selftest_catches_all_seeded_coherence_bugs():
    out = io.StringIO()
    rc = coh.run_selftest(out=out)
    assert rc == 0, out.getvalue()
    n = len(coh.SEEDED_MUTATIONS)
    assert n == 5       # the sixth, stale-folded-cache, needs item 8
    assert f"{n}/{n} seeded coherence bugs caught" in out.getvalue()


def test_each_seeded_mutation_anchors_once_in_the_port():
    src = coh._load_sources()
    for name, rel, old, _new, _rule in coh.SEEDED_MUTATIONS:
        assert src[rel].count(old) == 1, name


# ---- CLI -----------------------------------------------------------------

def test_cli_update_then_gate_roundtrip(tmp_path, capsys):
    path = tmp_path / "coherence_manifest.json"
    assert coh.main(["--manifest", str(path)]) == 1      # no manifest
    assert "--update" in capsys.readouterr().err
    assert coh.main(["--update", "--manifest", str(path)]) == 0
    assert coh.main(["--manifest", str(path)]) == 0
    capsys.readouterr()
    # poison one pinned method: the gate must fail with the hint
    manifest = json.loads(path.read_text())
    manifest["methods"]["SessionPool._sync_ctl"]["reads"] = []
    path.write_text(json.dumps(manifest))
    assert coh.main(["--manifest", str(path)]) == 1
    captured = capsys.readouterr()
    assert "effect drift" in captured.out
    assert "--update" in captured.err
