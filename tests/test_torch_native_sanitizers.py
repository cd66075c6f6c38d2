"""The port's native host library (``rectpu_torch/io/native``) under
sanitizers, as ``tests/test_native_sanitizers.py`` runs rectpu's: the port's
three sources with its copy of the test program (``loader_test_main.cc``)
built by g++ under ASan+UBSan and under TSan, and run to "loader_test ok".
The port's test program writes its scratch CSV where it is told (this test's
temporary directory), so it shares no file with rectpu's runs. Skipped when
g++ or the sanitizer runtimes are unavailable, as rectpu's is.

And the sources stay rectpu's: the port's four ``.cc`` files equal rectpu's
once comments and blank lines are stripped, but for the test program's one
stated change (the scratch CSV's path from ``argv[1]``).
"""

import re
import subprocess
from pathlib import Path

import pytest

ROOT = Path(__file__).parent.parent
NATIVE = ROOT / "rectpu_torch" / "io" / "native"
RECTPU_NATIVE = ROOT / "rectpu" / "io" / "native"
FILES = ("farmhash.cc", "csv_loader.cc", "json_columns.cc", "loader_test_main.cc")
# the port's test program: its scratch CSV's path may be given (rectpu's lines beside)
DRIVER_CHANGE = (
    ('int main(int argc, char** argv) {\n'
     '  const char* path = argc > 1 ? argv[1] : "/tmp/rectpu_loader_test.csv";'),
    'int main() {\n  const char* path = "/tmp/rectpu_loader_test.csv";',
)


def _build_and_run(tmp_path, sanitize: str):
    out = tmp_path / f"loader_test_{sanitize.replace(',', '_')}"
    cmd = ["g++", "-O1", "-g", "-std=c++17", "-pthread", f"-fsanitize={sanitize}",
           "-fno-omit-frame-pointer", *(str(NATIVE / f) for f in FILES), "-o", str(out)]
    build = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if build.returncode != 0:
        pytest.skip(f"sanitizer build unavailable: {build.stderr[-300:]}")
    csv = tmp_path / "loader_test.csv"
    run = subprocess.run([str(out), str(csv)], capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, f"sanitizer run failed:\n{run.stdout}\n{run.stderr}"
    assert "loader_test ok" in run.stdout
    assert not csv.exists()  # the program removes its scratch CSV


def test_asan_ubsan(tmp_path):
    _build_and_run(tmp_path, "address,undefined")


def test_tsan(tmp_path):
    _build_and_run(tmp_path, "thread")


def _code(text: str) -> str:
    """The source without comments, trailing blanks and blank lines."""
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    lines = (re.sub(r"//.*$", "", line).rstrip() for line in text.splitlines())
    return "\n".join(line for line in lines if line)


@pytest.mark.parametrize("name", FILES)
def test_sources_equal_rectpus_outside_comments(name):
    mine = _code((NATIVE / name).read_text())
    theirs = _code((RECTPU_NATIVE / name).read_text())
    if name == "loader_test_main.cc":
        assert mine.count(DRIVER_CHANGE[0]) == 1
        mine = mine.replace(*DRIVER_CHANGE)
    assert mine == theirs
