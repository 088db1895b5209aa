"""DatabaseManager network lifecycle against a local HTTP server.

The reference's own suite exercises the real download+compile path
(``/root/reference/tests/test_adversarial.py:43-45``); with zero egress here,
an ``http.server`` on localhost serves the same raw-file layout
(``<owner>/<repo>/<branch>/<db>.toml|.gbk``) so ``install`` / the ``update``
semver gate / HTTP error translation (ref ``db/manager.py:306-395``) run for
real, request-by-request.
"""

import http.server
import json
import threading
from functools import partial
from pathlib import Path

import numpy as np
import pytest

from kaptive_tpu.db import Database, DatabaseManager
from kaptive_tpu.db.models import DatabaseError
from synthetic import make_synthetic_db

OWNER, REPO, BRANCH, DBNAME = "testowner", "test-db-repo", "main", "TestDB"


class _LoggingHandler(http.server.SimpleHTTPRequestHandler):
    requests: list[str] = []

    def log_message(self, *a):  # keep pytest output clean
        pass

    def do_GET(self):
        type(self).requests.append(self.path)
        super().do_GET()


@pytest.fixture()
def served_db(tmp_path, monkeypatch):
    rng = np.random.default_rng(11)
    repo_dir = tmp_path / "www" / OWNER / REPO / BRANCH
    repo_dir.mkdir(parents=True)
    make_synthetic_db(repo_dir, rng, n_loci=2, genes_per_locus=3, name=DBNAME,
                      keyword="http_db")
    # Point the metadata's own provenance at the served repo (update() follows
    # owner/repo/branch from the LOCAL metadata, ref db/manager.py:189-249).
    toml_path = repo_dir / f"{DBNAME}.toml"
    toml_path.write_text(
        toml_path.read_text()
        .replace('owner = "example"', f'owner = "{OWNER}"')
        .replace('repo = "example-db"', f'repo = "{REPO}"')
    )

    handler = partial(_LoggingHandler, directory=str(tmp_path / "www"))
    _LoggingHandler.requests = []
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]

    monkeypatch.setenv("KAPTIVE_DB_RAW_BASE", f"http://127.0.0.1:{port}")
    monkeypatch.setenv("KAPTIVE_DB_DIR", str(tmp_path / "cache"))
    monkeypatch.setitem(DatabaseManager._KNOWN, "http_db", (OWNER, REPO, DBNAME))
    try:
        yield repo_dir, _LoggingHandler.requests
    finally:
        server.shutdown()
        DatabaseManager._KNOWN.pop("http_db", None)


def test_install_fetches_compiles_and_caches(served_db):
    repo_dir, requests = served_db
    db = DatabaseManager.install("http_db")
    assert isinstance(db, Database)
    assert db.metadata.keyword == "http_db"
    assert tuple(db.loci.ids)[:2] == ("KL1", "KL2")
    # Both raw files were fetched, pickle + JSON sidecar cached.
    assert any(p.endswith(f"{DBNAME}.toml") for p in requests)
    assert any(p.endswith(f"{DBNAME}.gbk") for p in requests)
    cache = Path(DatabaseManager._db_dir())
    assert (cache / "http_db.pkl").is_file()
    sidecar = json.loads((cache / "http_db.json").read_text())
    assert sidecar["version"] == "1.0.0"
    assert "http_db" in DatabaseManager.installed()
    # load() round-trips the cached pickle.
    assert tuple(DatabaseManager.load("http_db").loci.ids)[:2] == ("KL1", "KL2")


def test_update_semver_gate_skips_equal_version(served_db):
    repo_dir, requests = served_db
    DatabaseManager.install("http_db")
    requests.clear()
    assert list(DatabaseManager.update("http_db")) == []
    # The gate decides from the metadata alone: .toml refetched, .gbk NOT.
    assert any(p.endswith(".toml") for p in requests)
    assert not any(p.endswith(".gbk") for p in requests)


def test_update_refetches_newer_version(served_db):
    repo_dir, requests = served_db
    DatabaseManager.install("http_db")
    toml_path = repo_dir / f"{DBNAME}.toml"
    toml_path.write_text(
        toml_path.read_text().replace('version = "1.0.0"', 'version = "1.2.3"')
    )
    requests.clear()
    updated = list(DatabaseManager.update("http_db"))
    assert len(updated) == 1 and updated[0].metadata.version == "1.2.3"
    assert any(p.endswith(".gbk") for p in requests)
    cache = Path(DatabaseManager._db_dir())
    assert json.loads((cache / "http_db.json").read_text())["version"] == "1.2.3"


def test_update_all_covers_installed(served_db):
    repo_dir, requests = served_db
    DatabaseManager.install("http_db")
    assert list(DatabaseManager.update("all")) == []  # same version everywhere


def test_missing_remote_file_translates_to_database_error(served_db):
    with pytest.raises(DatabaseError, match="Remote file not found"):
        DatabaseManager.add(OWNER, REPO, "NoSuchDB")


def test_connection_error_translates_to_database_error(served_db, monkeypatch):
    monkeypatch.setenv("KAPTIVE_DB_RAW_BASE", "http://127.0.0.1:9")  # nothing listens
    with pytest.raises(DatabaseError, match="Network error"):
        DatabaseManager.add(OWNER, REPO, DBNAME)


def test_get_keyword_auto_installs(served_db):
    db = DatabaseManager.get("http_db")
    assert isinstance(db, Database) and db.metadata.keyword == "http_db"
    # Second get() serves from cache without touching the network.
    _, requests = served_db
    requests.clear()
    db2 = DatabaseManager.get("http_db")
    assert tuple(db2.loci.ids) == tuple(db.loci.ids)
    assert requests == []
