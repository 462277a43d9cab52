"""The port's analysis chain against nltk and the JAX package's, on the CPU.

The port stems English through the native library's Porter2
(``native/stem_export.cpp``), where the JAX package calls nltk's Snowball
stemmer; every word here must stem the same. The JAX package's term
generator, with nltk, and the port's (a pinned copy, over the port's
stemmer) give the same terms for the same text. The languages of
``stem_extra*.py`` stem as in the JAX package; the other Snowball
languages go through nltk (tests/test_torch_import.py holds that they
refuse by name where nltk is missing); an unknown language resolves to
None (no stemming), as in the JAX package. Where nltk is missing, a
non-ASCII English word refuses by name rather than take the native
stemmer's other stem.
"""

import os
import subprocess
import sys

import pytest
from nltk.stem.snowball import SnowballStemmer

from xapiand_tpu.analysis import stem as jstem
from xapiand_tpu.analysis.termgen import DocumentTerms as JDocumentTerms
from xapiand_tpu.analysis.termgen import TermGenerator as JTermGenerator
from xapiand_tpu_torch import native
from xapiand_tpu_torch.analysis import stem as pstem
from xapiand_tpu_torch.analysis.termgen import DocumentTerms, TermGenerator
from xapiand_tpu_torch.utils import synth_docs as sd

TRICKY = ("generously generous generate generation skies sky dying lying "
          "news innings outings cannings howe atlas cosmos bias andes "
          "succeeded proceeded exceeded gently ugly early only singly "
          "consign consigned consigning consignment consist consisted "
          "knack knackeries knavish kneaded kneel kneeling kneels knees "
          "a is be by i's it's o'neil 'quoted' yes y youth yyyy "
          "hopping hoping hopped hoped sized sizing feed agreed "
          "classically communication communicate universal universe "
          "arsenal arsenic commune community relational conditional "
          "rational valenci hesitanci digitizer conformabli radicalli "
          "differentli vileli analogousli vietnamization predication "
          "operator feudalism decisiveness hopefulness callousness "
          "formaliti sensitiviti sensibiliti triplicate formative "
          "formalize electriciti electrical hopeful goodness").split()


def _words():
    return sorted(set(TRICKY + sd._vocab() +
                      [w.upper() for w in TRICKY[:5]]))


def test_native_stemmer_is_nltks_english():
    """Every word: native Porter2 == nltk's EnglishStemmer (lowercase input,
    as the term generator lowercases before it stems)."""
    nl = SnowballStemmer("english")
    assert native.lib is not None, native.build_info
    for w in _words():
        w = w.lower()
        assert native.stem_english(w) == nl.stem(w), w


def test_port_stem_equals_the_jax_package():
    for lang in ("english", "en", "porter", "earlyenglish", "lovins",
                 "german2", "kraaij-pohlmann", "french", "es", "ru"):
        p, j = pstem.Stem(lang), jstem.Stem(lang)
        assert p.language == j.language, lang
        for w in _words()[:200]:
            assert p(w.lower()) == j(w.lower()), (lang, w)


def test_non_ascii_english_goes_through_nltk():
    nl = SnowballStemmer("english")
    for w in ("naïvely", "cafés", "résumés", "façades"):
        assert pstem.Stem("english")(w) == nl.stem(w)


NO_NLTK_NON_ASCII = """
import sys
from xapiand_tpu_torch.analysis.stem import Stem, StemError
from xapiand_tpu_torch.database import Database
assert Stem("english")("running") == "run"
for w in ("naïvely", "cafés"):
    try:
        Stem("english")(w)
    except StemError as e:
        assert "english" in str(e) and "nltk" in str(e), e
    else:
        raise AssertionError(f"{w} stemmed without nltk")
db = Database(device="cpu")
db.index_document({"about": "plain ascii runners"}, doc_id="a")
try:
    db.index_document({"about": "the cafés were naïvely run"}, doc_id="b")
    db.commit()
except StemError as e:
    assert "nltk" in str(e), e
else:
    raise AssertionError("non-ASCII English text indexed without nltk")
assert "nltk" not in sys.modules
print("ok")
"""


def test_non_ascii_english_without_nltk_refuses(tmp_path):
    """With nltk stubbed out, ASCII English stems through the native
    Porter2, and a non-ASCII English word (whose native stem may differ
    from nltk's) raises StemError naming nltk, when stemmed alone and when
    a Database indexes text that holds it."""
    (tmp_path / "nltk.py").write_text(
        "raise ModuleNotFoundError(\"No module named 'nltk'\", name='nltk')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        p for p in (str(tmp_path), root, os.environ.get("PYTHONPATH"))
        if p))
    r = subprocess.run([sys.executable, "-c", NO_NLTK_NON_ASCII], env=env,
                       cwd=root, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


@pytest.mark.parametrize("lang", [None, "", "none", "klingon", "xx"])
def test_unknown_languages_do_not_stem(lang):
    assert pstem.resolve_language(lang) is None
    assert jstem.resolve_language(lang) is None
    assert pstem.Stem(lang)("running") == "running"


@pytest.mark.parametrize("strategy", ["some", "all", "all_z", "none"])
def test_term_generator_equals_the_jax_package(strategy):
    """The pinned term generator over the port's stemmer: the same terms,
    wdfs and positions as the JAX package's over nltk."""
    text = " ".join(TRICKY) + " The runners RAN; running, runs! Café naïve"
    got, want = DocumentTerms(), JDocumentTerms()
    TermGenerator("english", stem_strategy=strategy).index_text(
        got, text, prefix="Fb.")
    JTermGenerator("english", stem_strategy=strategy).index_text(
        want, text, prefix="Fb.")
    assert len(got.terms) > 20
    assert {t: (e.wdf, e.positions) for t, e in got.terms.items()} == \
        {t: (e.wdf, e.positions) for t, e in want.terms.items()}
