"""Snowball stemmers, continued: the reference languages NLTK lacks that
round 2's stem_extra.py did not cover - armenian, basque, catalan,
lithuanian, tamil, turkish (reference compiles the same public algorithms
from src/xapian/languages/*.sbl via its bundled Snowball compiler).

Each port follows the .sbl control flow (longest-match among tables,
R1/R2/RV region gates, grouping tests); suffix tables are the public
Snowball data. Every stemmer here is fuzz-verified word-for-word against
the reference's own generated C++ stemmer compiled standalone
(tests/test_stem_extra2.py documents the oracle recipe).
"""

from __future__ import annotations


def _longest_suffix(word: str, lb: int, suffixes) -> str | None:
    """Snowball backward `[substring] among(...)`: the longest entry that
    is a suffix of `word` without crossing the backward limit `lb`."""
    best = None
    n = len(word)
    for s in suffixes:
        if (best is None or len(s) > len(best)) and n - len(s) >= lb \
                and word.endswith(s):
            best = s
    return best


# ---------------------------------------------------------------------------
# armenian (armenian.sbl: mark_regions pV/p2, backward ending/verb/
# adjective/noun delete passes; ending gated on R2)
# ---------------------------------------------------------------------------

_HY_V = "աէիօւեոը"  # a e i o u ye vo y

_HY_ADJECTIVE = (
    'բար', 'պես', 'որէն', 'ովին', 'ակի', 'լայն', 'րորդ', 'երորդ', 'ական',
    'ալի', 'կոտ', 'եկեն', 'որակ', 'եղ', 'վուն', 'երեն', 'արան', 'են',
    'ավետ', 'գին', 'իվ', 'ատ', 'ին')
_HY_VERB = (
    'ում', 'վում', 'ալու', 'ելու', 'վել', 'անալ', 'ելուց', 'ալուց', 'ըալ',
    'ըել', 'ալով', 'ելով', 'ալիս', 'ելիս', 'ենալ', 'ացնալ', 'եցնել', 'ցնել',
    'նել', 'ատել', 'ոտել', 'կոտել', 'տել', 'ված', 'եցվել', 'ացվել', 'եցիր',
    'ացիր', 'եցինք', 'ացինք', 'վեցիր', 'վեցինք', 'վեցիք', 'վեցին', 'ացրիր',
    'ացրեց', 'ացրինք', 'ացրիք', 'ացրին', 'եցիք', 'ացիք', 'եցին', 'ացին',
    'ացար', 'ացավ', 'ացանք', 'ացաք', 'ացան', 'վեցի', 'ացրի', 'եցար',
    'եցավ', 'ցանք', 'ցաք', 'ցան', 'ացա', 'ացի', 'եցա', 'չել', 'եցի', 'ար',
    'ավ', 'անք', 'աք', 'ան', 'ալ', 'ել', 'եց', 'աց', 'վե', 'ա')
_HY_NOUN = (
    'ածո', 'անակ', 'անօց', 'արան', 'արք', 'պան', 'ստան', 'եղէն', 'ենք',
    'իկ', 'իչ', 'իք', 'մունք', 'յակ', 'յուն', 'ոնք', 'որդ', 'ոց', 'չեք',
    'վածք', 'վոր', 'ավոր', 'ություն', 'ուկ', 'ուհի', 'ույթ', 'ույք',
    'ուստ', 'ուս', 'ցի', 'ալիք', 'անիք', 'իլ', 'իչք', 'ունք', 'գար', 'ու',
    'ակ', 'ան', 'ք')
_HY_ENDING = (
    'ները', 'ներն', 'ների', 'ներդ', 'երից', 'ներից', 'երի', 'երդ', 'երն',
    'երը', 'ներին', 'ությանն', 'ությանը', 'ությանս', 'ությանդ', 'ության',
    'երին', 'ին', 'սա', 'ոջ', 'ից', 'երով', 'ներով', 'երում', 'ներում',
    'ուն', 'ուդ', 'վանս', 'վանը', 'վանդ', 'անը', 'անդ', 'վան', 'ոջը',
    'ոջս', 'ոջդ', 'ոց', 'ուց', 'ոջից', 'ցից', 'վից', 'վի', 'վով', 'ով',
    'անով', 'անում', 'վանից', 'ամբ', 'ան', 'ներ', 'եր', 'վա', 'ը', 'ն',
    'դ', 'ց', 'ի')


def _hy_mark(word: str) -> tuple[int, int]:
    """pV = past the first vowel; p2 = past the vowel/non-vowel pattern
    repeated twice (armenian.sbl mark_regions)."""
    n = len(word)
    pV = p2 = n
    c = 0
    while c < n and word[c] not in _HY_V:
        c += 1
    if c < n:
        c += 1
        pV = c
        while c < n and word[c] in _HY_V:
            c += 1
        if c < n:
            c += 1
            while c < n and word[c] not in _HY_V:
                c += 1
            if c < n:
                c += 1
                while c < n and word[c] in _HY_V:
                    c += 1
                if c < n:
                    p2 = c + 1
    return pV, p2


def stem_armenian(word: str) -> str:
    pV, p2 = _hy_mark(word)
    # do ending (R2-gated), verb, adjective, noun - each once, in order
    s = _longest_suffix(word, pV, _HY_ENDING)
    if s is not None and len(word) - len(s) >= p2:
        word = word[: -len(s)]
    for table in (_HY_VERB, _HY_ADJECTIVE, _HY_NOUN):
        s = _longest_suffix(word, pV, table)
        if s is not None:
            word = word[: -len(s)]
    return word


EXTRA_STEMMERS_2 = {
    "armenian": stem_armenian,
}


# ---------------------------------------------------------------------------
# catalan (catalan.sbl: R1/R2 marks, backward attached_pronoun ->
# (standard_suffix or verb_suffix) -> residual_suffix, forward cleaning)
# ---------------------------------------------------------------------------

_CA_V = "aeiou\u00e1\u00e0\u00e9\u00e8\u00ed\u00ef\u00f3\u00f2\u00fa\u00fc"

_CA_PRON = ("'s", "'hi", "'ho", "'l", "'ls", '-ls', '-la', '-les', '-li',
    'vos', 'se', 'nos', '-nos', '-us', 'us', "'n", "'ns", '-n', '-ns', "'m",
    '-me', '-m', '-te', "'t", 'li', 'lo', 'los', 'me', 'sela', 'selo',
    'selas', 'selos', 'le', 'la', 'las', 'les', 'ens', 'ho', 'hi')

_CA_STD_R1DEL = ('ar', 'atge', 'formes', 'icte', 'ictes', 'ell', 'ells',
    'ella', 'és', 'ès', 'esc', 'essa', 'et', 'ets', 'eta', 'eres', 'eries',
    'ers', 'ina', 'ines', 'able', 'ls', 'ió', 'itat', 'itats', 'itzar', 'iva',
    'ives', 'ivisme', 'ius', 'fer', 'ment', 'amen', 'ament', 'aments',
    'ments', 'ot', 'sfera', 'al', 'als', 'era', 'ana', 'iste', 'aire', 'eria',
    'esa', 'eses', 'esos', 'or', 'ícia', 'ícies', 'icis', 'ici', 'íci',
    'ícis', 'ària', 'àries', 'alla', 'ció', 'cions', 'nça', 'nces', 'ó',
    'dor', 'all', 'il', 'ístic', 'enc', 'enca', 'ís', 'issa', 'issos',
    'íssem', 'íssiu', 'issem', 'isseu', 'ísseu', 'ós', 'osa', 'dora', 'dores',
    'dors', 'adura', 'ble', 'bles', 'ívol', 'ívola', 'dís', 'egar', 'ejar',
    'ificar', 'itar', 'ables', 'adors', 'idores', 'idors', 'adora', 'ació',
    'doras', 'dur', 'dures', 'allengües', 'ant', 'ants', 'ancia', 'ancies',
    'atòria', 'atòries', 'tori', 'toris', 'ats', 'ions', 'ota', 'isam', 'ors',
    'ora', 'ores', 'isament', 'bilitat', 'bilitats', 'ivitat', 'ivitats',
    'ari', 'aris', 'ionisme', 'ionista', 'ionistes', 'ialista', 'ialistes',
    'ialisme', 'ialismes', 'ud', 'uts', 'uds', 'encia', 'encies', 'ència',
    'ències', 'ïtat', 'ïtats', 'atiu', 'atius', 'atives', 'ativa', 'ativitat',
    'ativitats', 'ible', 'ibles', 'assa', 'asses', 'assos', 'ent', 'ents',
    'íssim', 'íssima', 'íssims', 'íssimes', 'ìssem', 'ìsseu', 'ìssin', 'ims',
    'ima', 'imes', 'isme', 'ista', 'ismes', 'istes', 'inia', 'inies', 'íinia',
    'ínies', 'ita', 'ites', 'triu', 'trius', 'oses', 'osos', 'ient', 'otes',
    'ots')

_CA_STD_R2DEL = ('acions', 'ada', 'ades')

_CA_STD_LOG = ('logía', 'logíes', 'logia', 'logies', 'logi', 'logis',
    'lógica', 'lógics', 'lógiques')

_CA_STD_IC = ('ic', 'ica', 'ics', 'iques')

_CA_STD_C = ('quíssim', 'quíssims', 'quíssimes', 'quíssima')

_CA_VERB_R1DEL = ('ador', 'adora', 'adors', 'adores', 're', 'ie', 'ent',
    'ents', 'udes', 'arà', 'eren', 'ará', 'arían', 'arías', 'arán', 'arás',
    'aríais', 'aria', 'arian', 'arien', 'aries', 'aràs', 'aría', 'aréis',
    'aríamos', 'aremos', 'ara', 'aré', 'arés', 'erían', 'erías', 'erán',
    'erás', 'eríais', 'ería', 'eréis', 'eríamos', 'eremos', 'erá', 'eré',
    'er', 'erau', 'erass', 'irían', 'irías', 'irán', 'irás', 'iríais', 'iría',
    'iréis', 'iríamos', 'iremos', 'irá', 'iré', 'írem', 'íreu', 'íeu', 'ia',
    'ies', 'íem', 'ìeu', 'ien', 'at', 'ut', 'uda', 'ava', 'aves', 'avem',
    'ávem', 'àvem', 'àveu', 'áveu', 'aven', 'au', 'ats', 'asseu', 'esseu',
    'eresseu', 'àsseu', 'àssem', 'àssim', 'àssiu', 'essen', 'esses', 'assen',
    'asses', 'assim', 'assiu', 'éssen', 'ésseu', 'éssim', 'éssiu', 'éssem',
    'í', 'ares', 'àrem', 'àreu', 'àren', 'aríem', 'aríeu', 'areu', 'aren',
    'ant', 'ïm', 'ïu', 'és', 'ïen', 'en', 'es', 'em', 'am', 'ams', 'ïa',
    'ïes', 'dre', 'eix', 'eixer', 'tzar', 'eixes', 'ides', 'ïdes', 'it', 'ït',
    'ïda', 'aba', 'ada', 'ades', 'ida', 'ía', 'iera', 'ad', 'ed', 'its', 'id',
    'ids', 'ase', 'iese', 'aste', 'iste', 'an', 'aban', 'ían', 'aran',
    'ieran', 'asen', 'iesen', 'aron', 'ieron', 'ado', 'ido', 'iendo', 'ió',
    'ar', 'ir', 'as', 'ieu', 'ii', 'io', 'ià', 'ess', 'essin', 'essis', 'ass',
    'assin', 'assis', 'essim', 'èssim', 'èssiu', 'abas', 'adas', 'idas',
    'ías', 'aras', 'ieras', 'ases', 'ieses', 'ís', 'áis', 'abais', 'íais',
    'arais', 'ierais', 'aseis', 'ieseis', 'asteis', 'isteis', 'ados', 'idos',
    'amos', 'ábamos', 'íamos', 'imos', 'ques', 'áramos', 'iéramos', 'iésemos',
    'ásemos', 'ira', 'iran', 'irem', 'iren', 'ires', 'ireu', 'iria', 'irien',
    'iries', 'irà', 'iràs', 'irè', 'irìem', 'irìeu', 'isquen', 'iguem',
    'igueu', 'esqui', 'esquin', 'esquis', 'eixi', 'eixin', 'eixis', 'eixen',
    'eixo', 'isin', 'isis', 'esques', 'sis', 'sin', 'int', 'iríem', 'iríeu',
    'isc', 'atges', 'esca', 'esquen', 'issen', 'isses', 'issin', 'issis',
    'isca', 'issiu', 'issim', 'ïsc', 'ïsca', 'ïssin', 'íssiu', 'íssim',
    'ïssis', 'ïguem', 'ïgueu', 'ïra', 'ïren', 'ïres', 'ïsquen', 'ïsques',
    'ïssen', 'ïsses', 'ïxo', 'ïxen', 'ïxes', 'ïx', 'ixo', 'ixen', 'ixes',
    'ix', 'ixa', 'inin', 'inis', 'ini', 'ineu', 'itza', 'itzi', 'itzeu',
    'itzis', 'itzo', 'itz', 'itzà', 'arem', 'in', 'às', 'iï', 'iïn', 'iïs')

_CA_VERB_R2DEL = ('ando',)

_CA_RES_R1DEL = ('os', 'a', 'o', 'á', 'à', 'í', 'ó', 'e', 'é', 'eu', 'iu',
    'is', 'i', 'ir', 's', 'ì', 'itz', 'ï', 'ïn', 'ïs', 'it')

_CA_RES_IC = ('iqu',)


_CA_STANDARD = ((_CA_STD_R1DEL, (1, None)), (_CA_STD_R2DEL, (2, None)),
                (_CA_STD_LOG, (2, "log")), (_CA_STD_IC, (2, "ic")),
                (_CA_STD_C, (1, "c")))
_CA_VERB = ((_CA_VERB_R1DEL, (1, None)), (_CA_VERB_R2DEL, (2, None)))
_CA_RESIDUAL = ((_CA_RES_R1DEL, (1, None)), (_CA_RES_IC, (1, "ic")))

_CA_CLEAN = str.maketrans({"\u00e1": "a", "\u00e0": "a", "\u00e9": "e",
                           "\u00e8": "e", "\u00ed": "i", "\u00ec": "i",
                           "\u00ef": "i", "\u00f3": "o", "\u00f2": "o",
                           "\u00fa": "u", "\u00fc": "u", "\u00b7": "."})


def _mark_r1r2(word: str, vowels: str) -> tuple[int, int]:
    """Standard Snowball R1/R2: past the first non-vowel following a
    vowel; R2 repeats from R1."""
    n = len(word)
    p1 = p2 = n
    c = 0
    while c < n and word[c] not in vowels:
        c += 1
    if c < n:
        c += 1
        while c < n and word[c] in vowels:
            c += 1
        if c < n:
            c += 1
            p1 = c
            while c < n and word[c] not in vowels:
                c += 1
            if c < n:
                c += 1
                while c < n and word[c] in vowels:
                    c += 1
                if c < n:
                    p2 = c + 1
    return p1, p2


def _apply_grouped(word: str, groups, p1: int, p2: int,
                   lb: int = 0) -> tuple[str, bool]:
    """Backward grouped among with R-gated delete/replace actions: find
    the longest matching suffix across ALL groups, then apply its group's
    (region, replacement) action; a failed gate fails the whole routine
    (Snowball: among picks one match, conditions do not re-try)."""
    best, tag = None, None
    n = len(word)
    for sufs, t in groups:
        for s in sufs:
            if (best is None or len(s) > len(best)) and n - len(s) >= lb \
                    and word.endswith(s):
                best, tag = s, t
    if best is None:
        return word, False
    start = n - len(best)
    region, repl = tag
    bound = p1 if region == 1 else p2
    if start < bound:
        return word, False
    return word[:start] + (repl or ""), True


def stem_catalan(word: str) -> str:
    p1, p2 = _mark_r1r2(word, _CA_V)
    s = _longest_suffix(word, 0, _CA_PRON)
    if s is not None and len(word) - len(s) >= p1:
        word = word[: -len(s)]
    w2, ok = _apply_grouped(word, _CA_STANDARD, p1, p2)
    if not ok:
        w2, ok = _apply_grouped(word, _CA_VERB, p1, p2)
    if ok:
        word = w2
    w2, ok = _apply_grouped(word, _CA_RESIDUAL, p1, p2)
    if ok:
        word = w2
    return word.translate(_CA_CLEAN)


EXTRA_STEMMERS_2["catalan"] = stem_catalan
_EU_ADITZAK = (
    (('le', 'la', 'tzaile', 'aldatu', 'atu', 'tzailea', 'taile', 'tailea',
      'pera', 'gale', 'galea', 'gura', 'kura', 'kor', 'korra', 'or', 'orra',
      'tun', 'tuna', 'gaitz', 'gaitza', 'kaitz', 'kaitza', 'ezin', 'ezina',
      'tezin', 'tezina', 'errez', 'erreza', 'karri', 'karria', 'tzaga',
      'tzaka', 'tzake', 'tzeke', 'ez', 'eza', 'tzez', 'keta', 'eta', 'etan',
      'pen', 'pena', 'tze', 'atze', 'kuntza', 'kunde', 'kundea', 'kune',
      'kunea', 'kuna', 'kera', 'era', 'kizun', 'kizuna', 'dura', 'tura',
      'men', 'mena', 'go', 'ago', 'tio', 'taldi', 'taldia', 'aldi', 'aldia',
      'gune', 'gunea', 'bide', 'bidea', 'pide', 'pidea', 'gai', 'gaia',
      'ki', 'kin', 'rekin', 'kina', 'kari', 'karia', 'ari', 'tari', 'etari',
      'gailu', 'gailua', 'kide', 'kidea', 'ide', 'idea', 'du', 'ka', 'kan',
      'an', 'ean', 'tu', 'lari', 'tatu', 'rean', 'tarazi', 'arazi', 'tzat',
      'bera', 'dako'), ('rv', None)),
    (('garri', 'garria', 'tza'), ('r2', None)),
    (('atseden',), (None, 'atseden')),
    (('arabera',), (None, 'arabera')),
    (('baditu',), (None, 'baditu')),
)


_EU_IZENAK = (
    (('ari', 'aria', 'bizia', 'kari', 'karia', 'lari', 'laria', 'tari',
      'taria', 'zain', 'zaina', 'tzain', 'tzaina', 'zale', 'zalea', 'tzale',
      'tzalea', 'aizun', 'orde', 'ordea', 'burua', 'ohi', 'ohia', 'kintza',
      'gintzo', 'gintzu', 'tzu', 'tzua', 'tzo', 'tzoa', 'kuntza', 'talde',
      'taldea', 'eria', 'keria', 'teria', 'di', 'za', 'ada', 'tara',
      'etara', 'tra', 'ta', 'tegi', 'tegia', 'keta', 'z', 'zko', 'zkoa',
      'ti', 'tia', 'tsu', 'tsua', 'zu', 'zua', 'bera', 'pera', 'zto',
      'ztoa', 'asi', 'asia', 'gile', 'gilea', 'estu', 'estua', 'larri',
      'larria', 'nahi', 'nahia', 'koi', 'koia', 'oi', 'oia', 'goi', 'min',
      'mina', 'dun', 'duna', 'duru', 'durua', 'duri', 'duria', 'os', 'osa',
      'oso', 'osoa', 'ar', 'ara', 'tar', 'dar', 'dara', 'tiar', 'tiara',
      'liar', 'liara', 'gabe', 'gabea', 'kabe', 'kabea', 'ga', 'ge', 'kada',
      'tasun', 'tasuna', 'asun', 'asuna', 'go', 'mendu', 'mendua', 'mentu',
      'mentua', 'mendi', 'mendia', 'zio', 'zioa', 'zino', 'zinoa', 'zione',
      'zionea', 'ezia', 'degi', 'degia', 'egi', 'egia', 'toki', 'tokia',
      'leku', 'lekua', 'gintza', 'alde', 'aldea', 'kalde', 'kaldea', 'gune',
      'gunea', 'une', 'unea', 'una', 'pe', 'pea', 'gibel', 'gibela', 'ondo',
      'ondoa', 'arte', 'artea', 'aurre', 'aurrea', 'etxe', 'etxea', 'ola',
      'ontzi', 'ontzia', 'gela', 'denda', 'taldi', 'taldia', 'aldi',
      'aldia', 'te', 'tea', 'zaro', 'zaroa', 'taro', 'taroa', 'oro', 'oroa',
      'aro', 'aroa', 'ero', 'eroa', 'eroz', 'eroza', 'ka', 'kan', 'kana',
      'tako', 'etako', 'takoa', 'kote', 'kotea', 'tzar', 'tzarra', 'handi',
      'handia', 'kondo', 'kondoa', 'skila', 'no', 'noa', 'ño', 'ñoa', 'ska',
      'xka', 'zka', 'tila', 'to', 'toa', 'tto', 'ttoa', 'txo', 'txoa',
      'txu', 'txua', 'anda', 'anga', 'urren', 'urrena', 'gai', 'gaia',
      'gei', 'geia', 'eme', 'emea', 'kume', 'kumea', 'sa', 'ko', 'eko',
      'koa', 'ena', 'enea', 'ne', 'nea', 'kor', 'korra', 'ez', 'eza', 'eta',
      'etan', 'ki', 'kia', 'kin', 'kina', 'tu', 'tua', 'du', 'dua', 'ek',
      'tarik', 'tariko', 'tan', 'ordu', 'ordua', 'oste', 'ostea', 'tzara',
      'ra', 'antza', 'behar', 'ro', 'giro', 'ak', 'zp', 'ket', 'kail',
      'kaila', 'ail', 'kirri', 'kirria', 'ngo', 'ngoa', 'ñi', 'sko', 'sta',
      'koitz', 'koitza', 'na', 'garren', 'garrena', 'kera', 'gerren',
      'gerrena', 'garna', 'kide', 'tz', 'tuko'), ('rv', None)),
    (('ora', 'garri', 'garria', 'or', 'buru', 'ren', 'tza'), ('r2', None)),
    (('joka',), (None, 'jok')),
    (('tzen', 'ten', 'en', 'tatu'), ('r1', None)),
    (('trako',), (None, 'tra')),
    (('minutuko',), (None, 'minutu')),
    (('zehar',), (None, 'zehar')),
    (('geldi',), (None, 'geldi')),
    (('igaro',), (None, 'igaro')),
    (('aurka',), (None, 'aurka')),
)


_EU_ADJ = (
    (('era', 'ero', 'go', 'tate', 'tade', 'date', 'dade', 'keria', 'ki',
      'to', 'ro', 'la', 'gi', 'larik', 'lanik', 'ik', 'ztik', 'rik'), ('rv',
      None)),
    (('zlea',), (None, 'z')),
)


def _among_at(word: str, cur: int, groups):
    """Longest entry across groups matching word[cur-len:cur] (backward
    among at an explicit right boundary)."""
    best, tag = None, None
    for sufs, t in groups:
        for s in sufs:
            if (best is None or len(s) > len(best)) and cur >= len(s) \
                    and word[cur - len(s): cur] == s:
                best, tag = s, t
    return best, tag


def _apply_at(word, cur, groups, marks):
    """One grouped-among application at cursor `cur` with gate checks.
    Returns (word, cur, success); replacements keep the cursor left of the
    replaced text (Snowball slice_from leaves cursor at bra)."""
    best, tag = _among_at(word, cur, groups)
    if best is None:
        return word, cur, False
    start = cur - len(best)
    gate, repl = tag
    if gate is not None and start < marks[gate]:
        return word, cur, False
    word = word[:start] + (repl or "") + word[cur:]
    return word, start, True


# ---------------------------------------------------------------------------
# basque (basque.sbl: Spanish-style RV + R1/R2, backward repeat aditzak ->
# repeat izenak -> do adjetiboak; the cursor carries across routines)
# ---------------------------------------------------------------------------

_EU_V = "aeiou"


def _mark_rv_es(word: str, vowels: str) -> int:
    """Spanish-style RV (basque.sbl mark_regions first do-block):
    v non-v: past the next vowel; v v: past the next non-vowel;
    non-v non-v: past the next vowel; non-v v: after the third letter."""
    n = len(word)
    if n < 2:
        return n
    if word[0] in vowels:
        if word[1] not in vowels:
            c = 2
            while c < n and word[c] not in vowels:
                c += 1
            return c + 1 if c < n else n
        c = 2
        while c < n and word[c] in vowels:
            c += 1
        return c + 1 if c < n else n
    if word[1] not in vowels:
        c = 2
        while c < n and word[c] not in vowels:
            c += 1
        return c + 1 if c < n else n
    return 3 if n >= 3 else n


def stem_basque(word: str) -> str:
    marks = {"rv": _mark_rv_es(word, _EU_V)}
    marks["r1"], marks["r2"] = _mark_r1r2(word, _EU_V)
    cur = len(word)
    for groups, once in ((_EU_ADITZAK, False), (_EU_IZENAK, False),
                         (_EU_ADJ, True)):
        while True:
            word, cur, ok = _apply_at(word, cur, groups, marks)
            if not ok or once:
                break
    return word


EXTRA_STEMMERS_2["basque"] = stem_basque
_LT_STEP1 = ('as', 'ias', 'is', 'ys', 'o', 'io', 'ui', 'iui', 'ą', 'ią', 'į',
    'u', 'iu', 'e', 'yje', 'y', 'au', 'i', 'an', 'ai', 'iai', 'ų', 'ių',
    'ams', 'am', 'iams', 'iam', 'us', 'ius', 'ais', 'iais', 'uose', 'iuose',
    'uos', 'iuos', 'uosna', 'iuosna', 'ysna', 'asis', 'aisi', 'osi', 'ųsi',
    'uisi', 'ąsi', 'usi', 'esi', 'uo', 'a', 'ia', 'os', 'ios', 'oj', 'oje',
    'ioje', 'osna', 'iosna', 'om', 'oms', 'ioms', 'omis', 'iomis', 'ose',
    'iose', 'on', 'ion', 'ė', 'ės', 'ei', 'ę', 'ėj', 'ėje', 'ėms', 'es',
    'ėmis', 'ėse', 'ėsna', 'ėn', 'aus', 'iaus', 'umi', 'iumi', 'uje', 'iuje',
    'iau', 'ūs', 'ums', 'umis', 'un', 'iun', 'ies', 'ens', 'enio', 'ers',
    'eniui', 'eriai', 'enį', 'erį', 'imi', 'eniu', 'erimi', 'eria', 'enyje',
    'eryje', 'ie', 'enie', 'erie', 'enys', 'erys', 'erų', 'ims', 'enims',
    'erims', 'enis', 'imis', 'enimis', 'yse', 'enyse', 'eryse', 'iem', 'iems',
    'ame', 'iame', 'uosi', 'iuosi', 'iesi', 'asi', 'iasi', 'amės', 'iamės',
    'at', 'ate', 'iat', 'iate', 'atės', 'iatės', 'isi', 'im', 'imės', 'it',
    'ite', 'ome', 'ot', 'ote', 'ėjo', 'ėjosi', 'otės', 'eisi', 'ėsi', 'ėm',
    'ėme', 'ėmės', 'ėt', 'ėte', 'ėtės', 'ausi', 'omės', 'siu', 'siuosi', 'si',
    'siesi', 's', 'ysis', 'sim', 'sime', 'sit', 'site', 'čiau', 'čiausi',
    'tum', 'tumei', 'tumeis', 'tumeisi', 'tųsi', 'tumėm', 'tumėme', 'tumėmės',
    'tute', 'tumėt', 'tumėte', 'tumėtės', 'k', 'ki', 'kimės', 'uoti', 'iuoti',
    'auti', 'iauti', 'oti', 'ioti', 'ėti', 'yti', 'inti', 'inėti', 'enti',
    'telėti', 'terėti', 'ti', 'ąs', 'iąs', 'įs', 'tųs', 'simės', 'sitės',
    'kite')

_LT_STEP2 = ('ing', 'išk', 'ėt', 'ot', 'uot', 'iuot', 'yt', 'iuk', 'iul',
    'ėl', 'yl', 'učiuk', 'uliuk', 'utėait', 'ok', 'iok', 'sv', 'šv', 'zgan',
    'op', 'iop', 'ain', 'ykšt', 'ykšč', 'esn', 'aus', 'iaus', 'ias', 'oj',
    'ioj', 'aj', 'iaj', 'ąj', 'iąj', 'uoj', 'iuoj', 'iej', 'ųj', 'iųj', 'ies',
    'uos', 'iuos', 'ais', 'iais', 'os', 'ios', 'ąs', 'iąs', 'dav', 'ant',
    'iant', 'int', 'ėj', 'ę', 'ėję', 'ęs', 'siant', 'dam', 'auj', 'jam',
    'iau', 'am')


# ---------------------------------------------------------------------------
# lithuanian (lithuanian.sbl: optional leading-'a' skip, R1 mark, backward
# fix_conflicts -> step1 (R1 delete) -> fix_chdz -> repeat step2 (R1
# delete) -> fix_chdz -> fix_gd; the cursor carries across routines)
# ---------------------------------------------------------------------------

_LT_V = "aeiyouąęįųėū"

_LT_FIX_CONFLICTS = (
    (("aite",), (None, "aitė")), (("aitės",), (None, "aitė")),
    (("uotės",), (None, "uotė")), (("uote",), (None, "uotė")),
    (("ėjime",), (None, "ėjimas")), (("esiu",), (None, "esys")),
    (("asius",), (None, "asys")), (("avime",), (None, "avimas")),
    (("ojime",), (None, "ojimas")), (("okatės",), (None, "okatė")),
    (("okate",), (None, "okatė")),
)
_LT_FIX_CHDZ = ((("č",), (None, "t")), (("dž",), (None, "d")))
_LT_FIX_GD = ((("gd",), (None, "g")),)


def stem_lithuanian(word: str) -> str:
    n = len(word)
    c = 1 if (n > 6 and word.startswith("a")) else 0
    p1 = n
    while c < n and word[c] not in _LT_V:
        c += 1
    if c < n:
        c += 1
        while c < n and word[c] in _LT_V:
            c += 1
        if c < n:
            p1 = c + 1
    marks = {}  # no gated groups; p1 enforced via the match limit below
    cur = len(word)

    def limited_delete(word, cur, table):
        """setlimit tomark p1 for ([substring]) ... delete: longest table
        entry ending at cur that starts at or after p1."""
        if cur < p1:
            return word, cur, False
        best = None
        for s in table:
            if (best is None or len(s) > len(best)) and cur - len(s) >= p1 \
                    and word[cur - len(s): cur] == s:
                best = s
        if best is None:
            return word, cur, False
        start = cur - len(best)
        return word[:start] + word[cur:], start, True

    # each routine is a `do`: backward-mode do restores the cursor's
    # distance from the end, so every routine restarts at the current end
    word, _, _ = _apply_at(word, len(word), _LT_FIX_CONFLICTS, marks)
    word, _, _ = limited_delete(word, len(word), _LT_STEP1)
    word, _, _ = _apply_at(word, len(word), _LT_FIX_CHDZ, marks)
    cur = len(word)
    while True:
        word, cur, ok = limited_delete(word, cur, _LT_STEP2)
        if not ok:
            break
    word, _, _ = _apply_at(word, len(word), _LT_FIX_CHDZ, marks)
    word, _, _ = _apply_at(word, len(word), _LT_FIX_GD, marks)
    return word


EXTRA_STEMMERS_2["lithuanian"] = stem_lithuanian


# ---------------------------------------------------------------------------
# turkish (turkish.sbl, Eryigit & Adali FSM affix stripping): backward
# mark_* suffix recognisers with vowel-harmony and optional-letter (y/n/s/U)
# context checks, driven by stem_nominal_verb_suffixes ->
# stem_noun_suffixes (with the recursive -ki chain) -> postlude. Deletions
# are permanent even when a later step of an alternation fails (Snowball
# backtracking restores only the cursor), which this port reproduces by
# threading the word through each branch.
# ---------------------------------------------------------------------------

_TR_VOWEL = "aeıioöuü"
_TR_U = "ıiuü"
_TR_HARMONY = {"a": "aıou", "e": "eiöü", "ı": "aı",
               "i": "ei", "o": "ou", "ö": "öü", "u": "ou",
               "ü": "öü"}


def _tr_harmony(w: str, c: int) -> bool:
    j = c - 1
    while j >= 0 and w[j] not in _TR_VOWEL:
        j -= 1
    if j < 0:
        return False
    allowed = _TR_HARMONY[w[j]]
    return any(w[k] in allowed for k in range(j - 1, -1, -1))


def _tr_opt_letter(w: str, c: int, letter: str):
    """mark_suffix_with_optional_{y,n,s}_consonant."""
    if c > 0 and w[c - 1] == letter:
        return c - 1 if (c >= 2 and w[c - 2] in _TR_VOWEL) else None
    return c if (c >= 2 and w[c - 2] in _TR_VOWEL) else None


def _tr_opt_U(w: str, c: int):
    if c > 0 and w[c - 1] in _TR_U:
        return c - 1 if (c >= 2 and w[c - 2] not in _TR_VOWEL) else None
    return c if (c >= 2 and w[c - 2] not in _TR_VOWEL) else None


def _tr_among(w: str, c: int, entries):
    best = None
    for s in entries:
        if (best is None or len(s) > len(best)) and c >= len(s) \
                and w[c - len(s): c] == s:
            best = s
    return None if best is None else c - len(best)


def _mk_possessives(w, c):
    c2 = _tr_among(w, c, ("mız", "miz", "muz", "müz", "nız",
                          "niz", "nuz", "nüz", "m", "n"))
    return None if c2 is None else _tr_opt_U(w, c2)


def _mk_sU(w, c):
    if not _tr_harmony(w, c) or c == 0 or w[c - 1] not in _TR_U:
        return None
    return _tr_opt_letter(w, c - 1, "s")


def _mk_lArI(w, c):
    return _tr_among(w, c, ("leri", "ları"))


def _mk_yU(w, c):
    if not _tr_harmony(w, c) or c == 0 or w[c - 1] not in _TR_U:
        return None
    return _tr_opt_letter(w, c - 1, "y")


def _harmony_among(entries, opt=None):
    def mk(w, c):
        if not _tr_harmony(w, c):
            return None
        c2 = _tr_among(w, c, entries)
        if c2 is None:
            return None
        return _tr_opt_letter(w, c2, opt) if opt else c2
    return mk


_mk_nU = _harmony_among(("nı", "ni", "nu", "nü"))
_mk_nUn = _harmony_among(("ın", "in", "un", "ün"), "n")
_mk_yA = _harmony_among(("a", "e"), "y")
_mk_nA = _harmony_among(("na", "ne"))
_mk_DA = _harmony_among(("da", "de", "ta", "te"))
_mk_ndA = _harmony_among(("nda", "nde"))
_mk_DAn = _harmony_among(("dan", "den", "tan", "ten"))
_mk_ndAn = _harmony_among(("ndan", "nden"))
_mk_ylA = _harmony_among(("la", "le"), "y")
_mk_ncA = _harmony_among(("ca", "ce"), "n")
_mk_yUm = _harmony_among(("ım", "im", "um", "üm"), "y")
_mk_sUn = _harmony_among(("sın", "sin", "sun", "sün"))
_mk_yUz = _harmony_among(("ız", "iz", "uz", "üz"), "y")
_mk_lAr = _harmony_among(("ler", "lar"))
_mk_nUz = _harmony_among(("nız", "niz", "nuz", "nüz"))
_mk_DUr = _harmony_among(("tır", "tir", "tur", "tür", "dır",
                          "dir", "dur", "dür"))
_mk_yDU = _harmony_among(
    ("tım", "tim", "tum", "tüm", "dım", "dim", "dum",
     "düm", "tın", "tin", "tun", "tün", "dın", "din",
     "dun", "dün", "tık", "tik", "tuk", "tük", "dık",
     "dik", "duk", "dük", "tı", "ti", "tu", "tü",
     "dı", "di", "du", "dü"), "y")
_mk_ymUs = _harmony_among(("mış", "miş", "muş",
                           "müş"), "y")


def _mk_sUnUz(w, c):
    return _tr_among(w, c, ("sınız", "siniz", "sunuz",
                            "sünüz"))


def _mk_cAsInA(w, c):
    return _tr_among(w, c, ("casına", "cesine"))


def _mk_ysA(w, c):
    c2 = _tr_among(w, c, ("sam", "san", "sak", "sem", "sen", "sek",
                          "sa", "se"))
    return None if c2 is None else _tr_opt_letter(w, c2, "y")


def _mk_yken(w, c):
    if c >= 3 and w[c - 3: c] == "ken":
        return _tr_opt_letter(w, c - 3, "y")
    return None


def _mk_ki(w, c):
    return c - 2 if (c >= 2 and w[c - 2: c] == "ki") else None


def _first(w, c, *marks):
    for mk in marks:
        r = mk(w, c)
        if r is not None:
            return r
    return None


def _tr_nominal_verb(w: str) -> tuple[str, bool]:
    """stem_nominal_verb_suffixes -> (word, continue_noun_stemming)."""
    n = len(w)
    c = _first(w, n, _mk_ymUs, _mk_yDU, _mk_ysA, _mk_yken)
    if c is not None:
        return w[:c], True
    c = _mk_cAsInA(w, n)
    if c is not None:
        c2 = _first(w, c, _mk_sUnUz, _mk_lAr, _mk_yUm, _mk_sUn, _mk_yUz)
        if c2 is None:
            c2 = c
        c3 = _mk_ymUs(w, c2)
        if c3 is not None:
            return w[:c3], True
    c = _mk_lAr(w, n)
    if c is not None:
        w = w[:c]
        c2 = _first(w, len(w), _mk_DUr, _mk_yDU, _mk_ysA, _mk_ymUs)
        if c2 is not None:
            w = w[:c2]
        return w, False                      # unset continue flag
    c = _mk_nUz(w, n)
    if c is not None:
        c2 = _first(w, c, _mk_yDU, _mk_ysA)
        if c2 is not None:
            return w[:c2], True
    c = _first(w, n, _mk_sUnUz, _mk_yUz, _mk_sUn, _mk_yUm)
    if c is not None:
        w = w[:c]
        c2 = _mk_ymUs(w, len(w))
        if c2 is not None:
            w = w[:c2]
        return w, True
    c = _mk_DUr(w, n)
    if c is not None:
        w = w[:c]
        n2 = len(w)
        c2 = _first(w, n2, _mk_sUnUz, _mk_lAr, _mk_yUm, _mk_sUn, _mk_yUz)
        if c2 is None:
            c2 = n2
        c3 = _mk_ymUs(w, c2)
        if c3 is not None:
            w = w[:c3]
        return w, True
    return w, True


def _tr_chain_ki(w: str) -> tuple[str, bool]:
    """stem_suffix_chain_before_ki (recursive)."""
    c = _mk_ki(w, len(w))
    if c is None:
        return w, False
    c2 = _mk_DA(w, c)
    if c2 is not None:
        w = w[:c2]
        n2 = len(w)
        c3 = _mk_lAr(w, n2)
        if c3 is not None:
            w = w[:c3]
            w, _ = _tr_chain_ki(w)
            return w, True
        c3 = _mk_possessives(w, n2)
        if c3 is not None:
            w = w[:c3]
            c4 = _mk_lAr(w, len(w))
            if c4 is not None:
                w = w[:c4]
                w, _ = _tr_chain_ki(w)
        return w, True
    c2 = _mk_nUn(w, c)
    if c2 is not None:
        w = w[:c2]
        n2 = len(w)
        c3 = _mk_lArI(w, n2)
        if c3 is not None:
            return w[:c3], True
        c3 = _first(w, n2, _mk_possessives, _mk_sU)
        if c3 is not None:
            w = w[:c3]
            c4 = _mk_lAr(w, len(w))
            if c4 is not None:
                w = w[:c4]
                w, _ = _tr_chain_ki(w)
            return w, True
        w, _ = _tr_chain_ki(w)
        return w, True
    c2 = _mk_ndA(w, c)
    if c2 is not None:
        c3 = _mk_lArI(w, c2)
        if c3 is not None:
            return w[:c3], True
        c3 = _mk_sU(w, c2)
        if c3 is not None:
            w = w[:c3]
            c4 = _mk_lAr(w, len(w))
            if c4 is not None:
                w = w[:c4]
                w, _ = _tr_chain_ki(w)
            return w, True
        w2, ok = _tr_chain_ki_at(w, c2)
        if ok:
            return w2, True
    return w, False


def _tr_chain_ki_at(w: str, c: int) -> tuple[str, bool]:
    """chain_ki invoked mid-word (cursor not at the end): matches 'ki'
    ending at c, continuing the same logic."""
    # Snowball recursion happens with cursor c; only the ndA branch calls
    # it without an intervening delete, so the suffix under inspection
    # ends at c rather than len(w).
    saved_tail = w[c:]
    w2, ok = _tr_chain_ki(w[:c])
    return (w2 + saved_tail if not ok else w2 + saved_tail), ok


def _tr_noun_suffixes(w: str) -> tuple[str, bool]:
    n = len(w)
    c = _mk_lAr(w, n)
    if c is not None:
        w = w[:c]
        w2, ok = _tr_chain_ki(w)
        return (w2 if ok else w), True
    c = _mk_ncA(w, n)
    if c is not None:
        w = w[:c]
        n2 = len(w)
        c2 = _mk_lArI(w, n2)
        if c2 is not None:
            return w[:c2], True
        c2 = _first(w, n2, _mk_possessives, _mk_sU)
        if c2 is not None:
            w = w[:c2]
            c3 = _mk_lAr(w, len(w))
            if c3 is not None:
                w = w[:c3]
                w, _ = _tr_chain_ki(w)
            return w, True
        c2 = _mk_lAr(w, n2)
        if c2 is not None:
            w = w[:c2]
            w2, ok = _tr_chain_ki(w)
            if ok:
                w = w2
        return w, True
    c = _first(w, n, _mk_ndA, _mk_nA)
    if c is not None:
        c2 = _mk_lArI(w, c)
        if c2 is not None:
            return w[:c2], True
        c2 = _mk_sU(w, c)
        if c2 is not None:
            w = w[:c2]
            c3 = _mk_lAr(w, len(w))
            if c3 is not None:
                w = w[:c3]
                w, _ = _tr_chain_ki(w)
            return w, True
        w2, ok = _tr_chain_ki_at(w, c)
        if ok:
            return w2, True
    c = _first(w, n, _mk_ndAn, _mk_nU)
    if c is not None:
        c2 = _mk_sU(w, c)
        if c2 is not None:
            w = w[:c2]
            c3 = _mk_lAr(w, len(w))
            if c3 is not None:
                w = w[:c3]
                w, _ = _tr_chain_ki(w)
            return w, True
        if _mk_lArI(w, c) is not None:
            return w, True                   # matched, nothing deleted
    c = _mk_DAn(w, n)
    if c is not None:
        w = w[:c]
        n2 = len(w)
        c2 = _mk_possessives(w, n2)
        if c2 is not None:
            w = w[:c2]
            c3 = _mk_lAr(w, len(w))
            if c3 is not None:
                w = w[:c3]
                w, _ = _tr_chain_ki(w)
            return w, True
        c2 = _mk_lAr(w, n2)
        if c2 is not None:
            w = w[:c2]
            w2, ok = _tr_chain_ki(w)
            if ok:
                w = w2
            return w, True
        w2, ok = _tr_chain_ki(w)
        if ok:
            w = w2
        return w, True
    c = _first(w, n, _mk_nUn, _mk_ylA)
    if c is not None:
        w = w[:c]
        n2 = len(w)
        c2 = _mk_lAr(w, n2)
        if c2 is not None:
            w = w[:c2]
            w2, ok = _tr_chain_ki(w)
            if ok:
                return w2, True
            # chain failed after the lAr delete: deletion persists, try
            # the next alternative on the truncated word
            n2 = len(w)
        c2 = _first(w, n2, _mk_possessives, _mk_sU)
        if c2 is not None:
            w = w[:c2]
            c3 = _mk_lAr(w, len(w))
            if c3 is not None:
                w = w[:c3]
                w, _ = _tr_chain_ki(w)
            return w, True
        w2, ok = _tr_chain_ki(w)
        if ok:
            w = w2
        return w, True
    c = _mk_lArI(w, n)
    if c is not None:
        return w[:c], True
    w2, ok = _tr_chain_ki(w)
    if ok:
        return w2, True
    c = _first(w, n, _mk_DA, _mk_yU, _mk_yA)
    if c is not None:
        w = w[:c]
        n2 = len(w)
        c2 = _mk_possessives(w, n2)
        if c2 is not None:
            w = w[:c2]
            c3 = _mk_lAr(w, len(w))
            eff = c3 if c3 is not None else len(w)
            w = w[:eff]
            w, _ = _tr_chain_ki(w)
        else:
            c2 = _mk_lAr(w, n2)
            if c2 is not None:
                w = w[:c2]
                w, _ = _tr_chain_ki(w)
        return w, True
    c = _first(w, n, _mk_possessives, _mk_sU)
    if c is not None:
        w = w[:c]
        c2 = _mk_lAr(w, len(w))
        if c2 is not None:
            w = w[:c2]
            w, _ = _tr_chain_ki(w)
        return w, True
    return w, False


def stem_turkish(word: str) -> str:
    if sum(1 for ch in word if ch in _TR_VOWEL) < 2:
        return word                          # more_than_one_syllable_word
    word, cont = _tr_nominal_verb(word)
    if not cont:
        return word                          # postlude skipped (sbl stem)
    word, _ = _tr_noun_suffixes(word)
    # postlude: reserved words keep their stem as-is
    if word in ("ad", "soyad"):
        return word
    if word.endswith(("d", "g")):
        j = len(word) - 1
        while j >= 0 and word[j] not in _TR_VOWEL:
            j -= 1
        if j >= 0:
            v = word[j]
            if v in "aı":
                word += "ı"
            elif v in "ei":
                word += "i"
            elif v in "ou":
                word += "u"
            elif v in "öü":
                word += "ü"
    last = {"b": "p", "c": "ç", "d": "t", "ğ": "k"}
    if word and word[-1] in last:
        word = word[:-1] + last[word[-1]]
    return word


EXTRA_STEMMERS_2["turkish"] = stem_turkish


# ---------------------------------------------------------------------------
# tamil (tamil.sbl, Damodharan Rajalingam's affix-stripping cascade):
# forward prefix removals + ordered backward suffix rule chains with
# script-aware context tests (pulli / vowel-sign / consonant classes).
# Alternatives are ORDERED (`or`), not longest-match, except inside
# among(...) tables; Snowball `test` restores only the cursor, so
# replacements inside test(...) persist - both reproduced here.
# ---------------------------------------------------------------------------

_TA_DEFS = {
    "aytham": 0x0B83, "a": 0x0B85, "aa": 0x0B86, "i": 0x0B87, "ii": 0x0B88,
    "u": 0x0B89, "uu": 0x0B8A, "e": 0x0B8E, "ee": 0x0B8F, "ai": 0x0B90,
    "o": 0x0B92, "oo": 0x0B93, "au": 0x0B94, "ka": 0x0B95, "nga": 0x0B99,
    "ca": 0x0B9A, "ja": 0x0B9C, "nya": 0x0B9E, "tta": 0x0B9F, "nna": 0x0BA3,
    "ta": 0x0BA4, "tha": 0x0BA4, "na": 0x0BA8, "nnna": 0x0BA9, "pa": 0x0BAA,
    "ma": 0x0BAE, "ya": 0x0BAF, "ra": 0x0BB0, "rra": 0x0BB1, "la": 0x0BB2,
    "lla": 0x0BB3, "llla": 0x0BB4, "zha": 0x0BB4, "va": 0x0BB5,
    "sha": 0x0BB6, "ssa": 0x0BB7, "sa": 0x0BB8, "ha": 0x0BB9,
    "vs_aa": 0x0BBE, "vs_i": 0x0BBF, "vs_ii": 0x0BC0, "vs_u": 0x0BC1,
    "vs_uu": 0x0BC2, "vs_e": 0x0BC6, "vs_ee": 0x0BC7, "vs_ai": 0x0BC8,
    "vs_o": 0x0BCA, "vs_oo": 0x0BCB, "vs_au": 0x0BCC, "pulli": 0x0BCD,
    "au_lmark": 0x0BD7,
}


def _ta(spec: str) -> str:
    """'{ka}{pulli}' -> the composed Tamil string."""
    return "".join(chr(_TA_DEFS[p]) for p in spec[1:-1].split("}{"))


_P = _ta("{pulli}")
_TA_HARD = tuple(_ta(f"{{{x}}}") for x in
                 ("ka", "ca", "tta", "tha", "pa", "rra"))
_TA_SOFT1 = tuple(_ta(f"{{{x}}}") for x in
                  ("ya", "ra", "la", "va", "zha", "lla"))
_TA_SOFT2 = tuple(_ta(f"{{{x}}}") for x in
                  ("nga", "nya", "nna", "na", "ma", "nnna"))
_TA_QPFX_C = tuple(_ta(f"{{{x}}}") for x in
                   ("ka", "ca", "tha", "va", "na", "pa", "ma", "ya",
                    "nga", "nya"))
_TA_VSIGNS = tuple(_ta(f"{{{x}}}") for x in
                   ("vs_aa", "vs_i", "vs_ii", "vs_e", "vs_ee", "vs_u",
                    "vs_uu", "vs_ai"))
_TA_INDEP_V = tuple(_ta(f"{{{x}}}") for x in
                    ("a", "aa", "i", "ii", "u", "uu", "e", "ee", "ai",
                     "o", "oo", "au"))


def _ta_ends(w, cur, spec):
    s = _ta(spec)
    return cur - len(s) if (cur >= len(s) and
                            w[cur - len(s): cur] == s) else None


def _ta_fix_va_start(w: str) -> str:
    for sign, repl in (("{va}{vs_oo}", "{oo}"), ("{va}{vs_o}", "{o}"),
                       ("{va}{vs_u}", "{u}"), ("{va}{vs_uu}", "{uu}")):
        s = _ta(sign)
        if w.startswith(s):
            return _ta(repl) + w[len(s):]
    return w


def _ta_fix_ending(w: str, st: dict) -> tuple[str, bool]:
    """One fix_ending application -> (word, fixed?)."""
    if len(w) <= 3:
        return w, False
    n = len(w)

    def rep(cur, repl=""):
        return w[:cur] + repl

    c = _longest_suffix(w, 0, (_ta("{na}{pulli}"), _ta("{na}{pulli}{ta}"),
                               _ta("{na}{pulli}{ta}{pulli}")))
    if c is not None:
        return w[: n - len(c)], True
    c = _ta_ends(w, n, "{ya}{pulli}")
    if c is not None and c > 0 and w[c - 1] in (
            _ta("{vs_ai}"), _ta("{vs_i}"), _ta("{vs_ii}")):
        return rep(c), True
    for spec, out in (("{tta}{pulli}{pa}{pulli}", "{lla}{pulli}"),
                      ("{tta}{pulli}{ka}{pulli}", "{lla}{pulli}")):
        c = _ta_ends(w, n, spec)
        if c is not None:
            return rep(c, _ta(out)), True
    c = _ta_ends(w, n, "{nnna}{pulli}{rra}{pulli}")
    if c is not None:
        return rep(c, _ta("{la}{pulli}")), True
    c = _ta_ends(w, n, "{rra}{pulli}{ka}{pulli}")
    if c is not None:
        return rep(c, _ta("{la}{pulli}")), True
    c = _ta_ends(w, n, "{tta}{pulli}{tta}{pulli}")
    if c is not None:
        return rep(c, _ta("{tta}{vs_u}")), True
    if st["vu"]:
        c = _ta_ends(w, n, "{ta}{pulli}{ta}{pulli}")
        if c is not None and not (c > 0 and w[c - 1] == _ta("{vs_ai}")):
            return rep(c, _ta("{ma}{pulli}")), True
    c = _ta_ends(w, n, "{vs_u}{ka}{pulli}")
    if c is None:
        c = _ta_ends(w, n, "{vs_u}{ka}{pulli}{ka}{pulli}")
    if c is not None:
        return rep(c, _P), True
    # [pulli C pulli C] (backward: pulli, hard-C, pulli, hard-C) = the
    # forward text C·C· ending the word
    if n >= 4 and w[n - 1] == _P and w[n - 2] in _TA_HARD \
            and w[n - 3] == _P and w[n - 4] in _TA_HARD:
        return rep(n - 4), True
    c = _ta_ends(w, n, "{vs_u}{ka}{pulli}")
    if c is not None:
        return rep(c, _P), True
    if n >= 2 and w[n - 1] == _P and w[n - 2] in _TA_HARD:
        return rep(n - 2), True
    if n >= 3 and w[n - 1] == _P \
            and (w[n - 2] in _TA_SOFT1 or w[n - 2] in _TA_SOFT2) \
            and w[n - 3] == _P:
        return rep(n - 3, _P), True
    c = _longest_suffix(w, 0, (_ta("{va}"), _ta("{ya}"),
                               _ta("{va}{pulli}")))
    if c is not None:
        return w[: n - len(c)], True
    c = _ta_ends(w, n, "{nnna}{vs_u}")
    if c is not None and not (c > 0 and w[c - 1] in _TA_VSIGNS):
        return rep(c), True
    c = _ta_ends(w, n, "{nga}{pulli}")
    if c is not None and not (c > 0 and w[c - 1] == _ta("{vs_ai}")):
        return rep(c, _ta("{ma}{pulli}")), True
    c = _ta_ends(w, n, "{nga}{pulli}")
    if c is not None:
        return rep(c), True
    if n >= 1 and w[n - 1] == _P and n >= 2 \
            and (w[n - 2] in _TA_VSIGNS or w[n - 2] == _P):
        return rep(n - 1), True
    return w, False


def _ta_fix_endings(w: str, st: dict) -> str:
    while True:
        w, ok = _ta_fix_ending(w, st)
        if not ok:
            return w


def stem_tamil(word: str) -> str:
    st = {"match": False, "vu": False}
    word, _ = _ta_fix_ending(word, st)
    if len(word) <= 4:
        return word                      # has_min_length fails mid-stem
    # remove_question_prefixes
    if len(word) >= 3 and word[0] == _ta("{e}") \
            and word[1] in _TA_QPFX_C and word[2] == _P:
        word = word[3:]
        word = _ta_fix_va_start(word)
    # remove_pronoun_prefixes
    if len(word) >= 3 and word[0] in (_ta("{a}"), _ta("{i}"), _ta("{u}")) \
            and word[1] in _TA_QPFX_C and word[2] == _P:
        word = word[3:]
        word = _ta_fix_va_start(word)
    # remove_question_suffixes
    if len(word) > 4:
        if word and word[-1] in (_ta("{vs_oo}"), _ta("{vs_ee}"),
                                 _ta("{vs_aa}")):
            word = word[:-1] + _P
        word = _ta_fix_endings(word, st)
    # remove_um
    if len(word) > 4:
        c = _ta_ends(word, len(word), "{vs_u}{ma}{pulli}")
        if c is not None:
            word = word[:c] + _P
        word, _ = _ta_fix_ending(word, st)
    # remove_common_word_endings
    if len(word) > 4:
        word = _ta_common_word_endings(word, st)
        word = _ta_fix_endings(word, st)
    # remove_vetrumai_urupukal
    if len(word) > 4:
        word = _ta_vetrumai(word, st)
        word = _ta_fix_endings(word, st)
    # remove_plural_suffix
    word = _ta_plural(word)
    # remove_command_suffixes
    if len(word) > 4:
        c = _longest_suffix(word, 0, (_ta("{pa}{vs_i}"),
                                      _ta("{va}{vs_i}")))
        if c is not None:
            word = word[: len(word) - len(c)]
    # remove_tense_suffixes
    st["match"] = True
    while st["match"]:
        word = _ta_tense_suffix(word, st)
    return word


def _ta_common_word_endings(w: str, st: dict) -> str:
    n = len(w)
    for spec in ("{vs_u}{tta}{nnna}{pulli}", "{vs_i}{la}{pulli}{la}{vs_ai}",
                 "{vs_i}{tta}{ma}{pulli}", "{vs_i}{nnna}{pulli}{rra}{vs_i}",
                 "{vs_aa}{ka}{vs_i}", "{vs_aa}{ka}{vs_i}{ya}",
                 "{vs_e}{nnna}{pulli}{rra}{vs_u}", "{vs_u}{lla}{pulli}{lla}",
                 "{vs_u}{tta}{vs_ai}{ya}", "{vs_u}{tta}{vs_ai}",
                 "{vs_e}{nnna}{vs_u}{ma}{pulli}", "LPL",
                 "{vs_e}{nnna}", "{vs_aa}{ka}{vs_i}"):
        if spec == "LPL":
            c = _ta_ends(w, n, "{la}{pulli}{la}")
            if c is not None and not (c > 0 and w[c - 1] in _TA_VSIGNS):
                st["match"] = True
                return w[:c] + _P
            continue
        c = _ta_ends(w, n, spec)
        if c is not None:
            st["match"] = True
            return w[:c] + _P
    c = _longest_suffix(w, 0, tuple(_ta(s) for s in (
        "{pa}{tta}{vs_u}", "{pa}{tta}{pulli}{tta}",
        "{pa}{tta}{pulli}{tta}{vs_u}", "{pa}{tta}{pulli}{tta}{ta}{vs_u}",
        "{pa}{tta}{pulli}{tta}{nna}", "{ka}{vs_u}{ra}{vs_i}{ya}",
        "{pa}{rra}{pulli}{rra}{vs_i}", "{va}{vs_i}{tta}{vs_u}",
        "{va}{vs_i}{tta}{pulli}{tta}{vs_u}",
        "{pa}{tta}{vs_i}{ta}{vs_aa}{nnna}", "{pa}{tta}{vs_i}",
        "{ta}{vs_aa}{nnna}", "{vs_e}{la}{pulli}{la}{vs_aa}{ma}{pulli}")))
    if c is not None:
        st["match"] = True
        return w[: n - len(c)]
    return w


def _ta_vetrumai(w: str, st: dict) -> str:
    st["vu"] = False
    n = len(w)
    matched = False
    c = _ta_ends(w, n, "{nnna}{vs_ai}")
    if c is not None:
        w = w[:c]
        matched = True
    if not matched:
        c = _ta_ends(w, n, "{vs_i}{nnna}{vs_ai}")
        if c is not None:
            w = w[:c] + _P
            matched = True
        else:
            c = _ta_ends(w, n, "{vs_ai}")
            if c is not None and not (c > 0 and w[c - 1] in _TA_HARD):
                w = w[:c] + _P
                matched = True
            elif c is not None and c >= 2 and w[c - 1] in _TA_HARD \
                    and w[c - 2] == _P:
                w = w[:c] + _P
                matched = True
    if not matched:
        for spec in ("{vs_o}{tta}{vs_u}", "{vs_oo}{tta}{vs_u}",
                     "{vs_i}{la}{pulli}", "{vs_i}{rra}{pulli}",
                     "INP", "{vs_i}{nnna}{pulli}{rra}{vs_u}",
                     "{vs_i}{ra}{vs_u}{na}{pulli}{ta}{vs_u}",
                     "{va}{vs_i}{tta}", "ITM", "{vs_aa}{la}{pulli}",
                     "{vs_u}{tta}{vs_ai}", "{vs_aa}{ma}{la}{pulli}",
                     "LP", "{vs_u}{lla}{pulli}"):
            if spec == "INP":
                c = _ta_ends(w, n, "{vs_i}{nnna}{pulli}")
                if c is not None and not (c > 0 and w[c - 1] == _ta("{ma}")):
                    w = w[:c] + _P
                    matched = True
                    break
                continue
            if spec == "ITM":
                if n >= 7:
                    c = _ta_ends(w, n, "{vs_i}{tta}{ma}{pulli}")
                    if c is not None:
                        w = w[:c] + _P
                        matched = True
                        break
                continue
            if spec == "LP":
                c = _ta_ends(w, n, "{la}{pulli}")
                if c is not None and not (c > 0 and w[c - 1] in _TA_VSIGNS):
                    w = w[:c] + _P
                    matched = True
                    break
                continue
            c = _ta_ends(w, n, spec)
            if c is not None:
                w = w[:c] + _P
                matched = True
                break
    if not matched:
        for spec in ("{ka}{nna}{pulli}", "{ma}{vs_u}{nnna}{pulli}",
                     "{ma}{vs_ee}{la}{pulli}", "{ma}{vs_ee}{rra}{pulli}",
                     "{ka}{vs_ii}{llla}{pulli}", "{pa}{vs_i}{nnna}{pulli}",
                     "TU"):
            if spec == "TU":
                c = _ta_ends(w, n, "{ta}{vs_u}")
                if c is not None and not (c > 0 and w[c - 1] in _TA_VSIGNS):
                    w = w[:c]
                    matched = True
                    break
                continue
            c = _ta_ends(w, n, spec)
            if c is not None:
                w = w[:c]
                matched = True
                break
    if not matched:
        c = _ta_ends(w, n, "{vs_ii}")
        if c is not None:
            w = w[:c] + _ta("{vs_i}")
            matched = True
    if matched:
        st["match"] = True
        st["vu"] = True
        c = _ta_ends(w, len(w), "{vs_i}{nnna}{pulli}")
        if c is not None:
            w = w[:c] + _P
    return w


def _ta_plural(w: str) -> str:
    n = len(w)
    c = _ta_ends(w, n, "{vs_u}{nga}{pulli}{ka}{lla}{pulli}")
    if c is not None and not (c > 0 and w[c - 1] in _TA_HARD):
        return w[:c] + _P
    c = _ta_ends(w, n, "{rra}{pulli}{ka}{lla}{pulli}")
    if c is not None:
        return w[:c] + _ta("{la}{pulli}")
    c = _ta_ends(w, n, "{tta}{pulli}{ka}{lla}{pulli}")
    if c is not None:
        return w[:c] + _ta("{lla}{pulli}")
    c = _ta_ends(w, n, "{ka}{lla}{pulli}")
    if c is not None:
        return w[:c]
    return w


def _ta_tense_suffix(w: str, st: dict) -> str:
    st["match"] = False
    if len(w) <= 4:
        return w
    n = len(w)
    c = _longest_suffix(w, 0, (
        _ta("{ka}{vs_o}{nna}{pulli}{tta}{vs_i}{ra}{pulli}"),
        _ta("{pa}{tta}{vs_u}")))
    if c is not None:
        w = w[: n - len(c)]
        st["match"] = True
    else:
        done = False
        for spec in ("{ma}{vs_aa}{ra}{pulli}", "{ma}{vs_i}{nnna}{pulli}",
                     "{nnna}{nnna}{pulli}", "{nnna}{vs_aa}{nnna}{pulli}",
                     "{nnna}{vs_aa}{lla}{pulli}", "{nnna}{vs_aa}{ra}{pulli}",
                     "VNP", "{nnna}{lla}{pulli}", "{va}{lla}{pulli}",
                     "{nnna}{ra}{pulli}", "{va}{ra}{pulli}", "{nnna}",
                     "{pa}", "{ka}", "{ta}", "{ya}", "{pa}{nnna}{pulli}",
                     "{pa}{lla}{pulli}", "{pa}{ra}{pulli}", "TU",
                     "{vs_i}{rra}{pulli}{rra}{vs_u}", "{pa}{ma}{pulli}",
                     "{nnna}{ma}{pulli}", "{ta}{vs_u}{ma}{pulli}",
                     "{rra}{vs_u}{ma}{pulli}", "{ka}{vs_u}{ma}{pulli}",
                     "{nnna}{vs_e}{nnna}{pulli}", "{nnna}{vs_ai}",
                     "{va}{vs_ai}"):
            if spec == "VNP":
                c = _ta_ends(w, n, "{va}{nnna}{pulli}")
                if c is not None and not (c > 0
                                          and w[c - 1] in _TA_INDEP_V):
                    w = w[:c]
                    st["match"] = True
                    done = True
                    break
                continue
            if spec == "TU":
                c = _ta_ends(w, n, "{ta}{vs_u}")
                if c is not None and not (c > 0 and w[c - 1] in _TA_VSIGNS):
                    w = w[:c]
                    st["match"] = True
                    done = True
                    break
                continue
            c = _ta_ends(w, n, spec)
            if c is not None:
                w = w[:c]
                st["match"] = True
                done = True
                break
        if not done:
            for spec in ("ANP", "{vs_aa}{lla}{pulli}", "{vs_aa}{ra}{pulli}",
                         "{vs_ee}{nnna}{pulli}", "{vs_aa}",
                         "{vs_aa}{ma}{pulli}", "{vs_e}{ma}{pulli}",
                         "{vs_ee}{ma}{pulli}", "{vs_oo}{ma}{pulli}",
                         "{ka}{vs_u}{ma}{pulli}", "{ta}{vs_u}{ma}{pulli}",
                         "{tta}{vs_u}{ma}{pulli}", "{rra}{vs_u}{ma}{pulli}",
                         "{vs_aa}{ya}{pulli}", "{nnna}{vs_e}{nnna}{pulli}",
                         "{nnna}{vs_i}{ra}{pulli}", "{vs_ii}{ra}{pulli}",
                         "{vs_ii}{ya}{ra}{pulli}"):
                if spec == "ANP":
                    c = _ta_ends(w, n, "{vs_aa}{nnna}{pulli}")
                    if c is not None and not (c > 0
                                              and w[c - 1] == _ta("{ca}")):
                        w = w[:c] + _P
                        st["match"] = True
                        done = True
                        break
                    continue
                c = _ta_ends(w, n, spec)
                if c is not None:
                    w = w[:c] + _P
                    st["match"] = True
                    done = True
                    break
        if not done:
            for spec in ("{ka}{vs_u}", "{ta}{vs_u}"):
                c = _ta_ends(w, n, spec)
                if c is not None and c > 0 and w[c - 1] == _P:
                    w = w[:c]
                    st["match"] = True
                    break
    c = _longest_suffix(w, 0, tuple(_ta(s) for s in (
        "{vs_aa}{na}{vs_i}{nnna}{pulli}{rra}",
        "{vs_aa}{na}{vs_i}{nnna}{pulli}{rra}{pulli}",
        "{ka}{vs_i}{nnna}{pulli}{rra}",
        "{ka}{vs_i}{nnna}{pulli}{rra}{pulli}",
        "{ka}{vs_i}{rra}", "{ka}{vs_i}{rra}{pulli}")))
    if c is not None:
        w = w[: len(w) - len(c)]
        st["match"] = True
    return _ta_fix_endings(w, st)


EXTRA_STEMMERS_2["tamil"] = stem_tamil


# ---------------------------------------------------------------------------
# german2 (german2.sbl: the german algorithm with an alternate prelude
# that folds ae/oe/ue -> umlauts, except after q, and protects u/y between
# vowels BEFORE folding)
# ---------------------------------------------------------------------------

_DE_V = "aeiouyäöü"
_DE_S_ENDING = "bdfghklmnrt"
_DE_ST_ENDING = "bdfghklmnt"


def _de2_prelude(w: str) -> str:
    # mark u/y between vowels; goto restores the cursor to the match
    # start, so marks can chain through shared vowels ("eueue" -> eUeUe)
    chars = list(w)
    for i in range(len(chars) - 2):
        if chars[i] in _DE_V and chars[i + 1] in "uy" \
                and chars[i + 2] in _DE_V:
            chars[i + 1] = chars[i + 1].upper()
    w = "".join(chars)
    # fold: ss for eszett, ae/oe/ue -> umlauts; 'qu' hops over the NEXT
    # two characters (they stay unfolded), and a hop past the end stops
    # the whole scan
    out = []
    i = 0
    n = len(w)
    while i < n:
        two = w[i: i + 2]
        if w[i] == "ß":
            out.append("ss")
            i += 1
        elif two == "qu":
            out.append("qu")
            i += 2
            if n - i < 2:
                break                    # hop 2 fails: scan ends
            out.append(w[i: i + 2])
            i += 2
        elif two == "ae":
            out.append("ä")
            i += 2
        elif two == "oe":
            out.append("ö")
            i += 2
        elif two == "ue":
            out.append("ü")
            i += 2
        else:
            out.append(w[i])
            i += 1
    out.append(w[i:])                    # rest verbatim after a failed hop
    return "".join(out)


def stem_german2(word: str) -> str:
    w = _de2_prelude(word)
    n = len(w)
    p1 = p2 = n
    if n >= 3:
        c = 0
        while c < n and w[c] not in _DE_V:
            c += 1
        if c < n:
            c += 1
            while c < n and w[c] in _DE_V:
                c += 1
            if c < n:
                c += 1
                p1 = max(c, 3)           # try($p1 < x  $p1 = x), x = 3
                while c < n and w[c] not in _DE_V:
                    c += 1
                if c < n:
                    c += 1
                    while c < n and w[c] in _DE_V:
                        c += 1
                    if c < n:
                        p2 = c + 1

    # block 1 (R1)
    s = _longest_suffix(w, 0, ("em", "ern", "er", "e", "en", "es", "s"))
    if s is not None:
        start = len(w) - len(s)
        if start >= p1:
            if s == "s":
                if start >= 1 and w[start - 1] in _DE_S_ENDING:
                    w = w[:start]
            else:
                w = w[:start]
                if s in ("e", "en", "es") and w.endswith("niss"):
                    w = w[:-1]           # try(['s'] 'nis' delete)
    # block 2 (R1)
    s = _longest_suffix(w, 0, ("en", "er", "est", "st"))
    if s is not None:
        start = len(w) - len(s)
        if start >= p1:
            if s == "st":
                if start >= 4 and w[start - 1] in _DE_ST_ENDING:
                    w = w[:start]        # st_ending hop 3 delete
            else:
                w = w[:start]
    # block 3 (R2)
    s = _longest_suffix(w, 0, ("end", "ung", "ig", "ik", "isch",
                               "lich", "heit", "keit"))
    if s is not None:
        start = len(w) - len(s)
        if start >= p2:
            if s in ("end", "ung"):
                w = w[:start]
                if w.endswith("ig") and not w.endswith("eig") \
                        and len(w) - 2 >= p2:
                    w = w[:-2]
            elif s in ("ig", "ik", "isch"):
                if not (start >= 1 and w[start - 1] == "e"):
                    w = w[:start]
            elif s in ("lich", "heit"):
                w = w[:start]
                for t in ("er", "en"):
                    if w.endswith(t) and len(w) - 2 >= p1:
                        w = w[:-2]
                        break
            else:                        # keit
                w = w[:start]
                t = _longest_suffix(w, 0, ("lich", "ig"))
                if t is not None and len(w) - len(t) >= p2:
                    w = w[: len(w) - len(t)]

    return w.translate(str.maketrans({"Y": "y", "U": "u", "ä": "a",
                                      "ö": "o", "ü": "u"}))


EXTRA_STEMMERS_2["german2"] = stem_german2
_LOVINS_ENDINGS = (
    ('alistically', 'B'),
    ('arizability', 'A'),
    ('izationally', 'B'),
    ('antialness', 'A'),
    ('arisations', 'A'),
    ('arizations', 'A'),
    ('entialness', 'A'),
    ('allically', 'C'),
    ('antaneous', 'A'),
    ('antiality', 'A'),
    ('arisation', 'A'),
    ('arization', 'A'),
    ('ationally', 'B'),
    ('ativeness', 'A'),
    ('eableness', 'E'),
    ('entations', 'A'),
    ('entiality', 'A'),
    ('entialize', 'A'),
    ('entiation', 'A'),
    ('ionalness', 'A'),
    ('istically', 'A'),
    ('itousness', 'A'),
    ('izability', 'A'),
    ('izational', 'A'),
    ('ableness', 'A'),
    ('arizable', 'A'),
    ('entation', 'A'),
    ('entially', 'A'),
    ('eousness', 'A'),
    ('ibleness', 'A'),
    ('icalness', 'A'),
    ('ionalism', 'A'),
    ('ionality', 'A'),
    ('ionalize', 'A'),
    ('iousness', 'A'),
    ('izations', 'A'),
    ('lessness', 'A'),
    ('ability', 'A'),
    ('aically', 'A'),
    ('alistic', 'B'),
    ('alities', 'A'),
    ('ariness', 'E'),
    ('aristic', 'A'),
    ('arizing', 'A'),
    ('ateness', 'A'),
    ('atingly', 'A'),
    ('ational', 'B'),
    ('atively', 'A'),
    ('ativism', 'A'),
    ('elihood', 'E'),
    ('encible', 'A'),
    ('entally', 'A'),
    ('entials', 'A'),
    ('entiate', 'A'),
    ('entness', 'A'),
    ('fulness', 'A'),
    ('ibility', 'A'),
    ('icalism', 'A'),
    ('icalist', 'A'),
    ('icality', 'A'),
    ('icalize', 'A'),
    ('ication', 'G'),
    ('icianry', 'A'),
    ('ination', 'A'),
    ('ingness', 'A'),
    ('ionally', 'A'),
    ('isation', 'A'),
    ('ishness', 'A'),
    ('istical', 'A'),
    ('iteness', 'A'),
    ('iveness', 'A'),
    ('ivistic', 'A'),
    ('ivities', 'A'),
    ('ization', 'F'),
    ('izement', 'A'),
    ('oidally', 'A'),
    ('ousness', 'A'),
    ('aceous', 'A'),
    ('acious', 'B'),
    ('action', 'G'),
    ('alness', 'A'),
    ('ancial', 'A'),
    ('ancies', 'A'),
    ('ancing', 'B'),
    ('ariser', 'A'),
    ('arized', 'A'),
    ('arizer', 'A'),
    ('atable', 'A'),
    ('ations', 'B'),
    ('atives', 'A'),
    ('eature', 'Z'),
    ('efully', 'A'),
    ('encies', 'A'),
    ('encing', 'A'),
    ('ential', 'A'),
    ('enting', 'C'),
    ('entist', 'A'),
    ('eously', 'A'),
    ('ialist', 'A'),
    ('iality', 'A'),
    ('ialize', 'A'),
    ('ically', 'A'),
    ('icance', 'A'),
    ('icians', 'A'),
    ('icists', 'A'),
    ('ifully', 'A'),
    ('ionals', 'A'),
    ('ionate', 'D'),
    ('ioning', 'A'),
    ('ionist', 'A'),
    ('iously', 'A'),
    ('istics', 'A'),
    ('izable', 'E'),
    ('lessly', 'A'),
    ('nesses', 'A'),
    ('oidism', 'A'),
    ('acies', 'A'),
    ('acity', 'A'),
    ('aging', 'B'),
    ('aical', 'A'),
    ('alist', 'A'),
    ('alism', 'B'),
    ('ality', 'A'),
    ('alize', 'A'),
    ('allic', 'BB'),
    ('anced', 'B'),
    ('ances', 'B'),
    ('antic', 'C'),
    ('arial', 'A'),
    ('aries', 'A'),
    ('arily', 'A'),
    ('arity', 'B'),
    ('arize', 'A'),
    ('aroid', 'A'),
    ('ately', 'A'),
    ('ating', 'I'),
    ('ation', 'B'),
    ('ative', 'A'),
    ('ators', 'A'),
    ('atory', 'A'),
    ('ature', 'E'),
    ('early', 'Y'),
    ('ehood', 'A'),
    ('eless', 'A'),
    ('elity', 'A'),
    ('ement', 'A'),
    ('enced', 'A'),
    ('ences', 'A'),
    ('eness', 'E'),
    ('ening', 'E'),
    ('ental', 'A'),
    ('ented', 'C'),
    ('ently', 'A'),
    ('fully', 'A'),
    ('ially', 'A'),
    ('icant', 'A'),
    ('ician', 'A'),
    ('icide', 'A'),
    ('icism', 'A'),
    ('icist', 'A'),
    ('icity', 'A'),
    ('idine', 'I'),
    ('iedly', 'A'),
    ('ihood', 'A'),
    ('inate', 'A'),
    ('iness', 'A'),
    ('ingly', 'B'),
    ('inism', 'J'),
    ('inity', 'CC'),
    ('ional', 'A'),
    ('ioned', 'A'),
    ('ished', 'A'),
    ('istic', 'A'),
    ('ities', 'A'),
    ('itous', 'A'),
    ('ively', 'A'),
    ('ivity', 'A'),
    ('izers', 'F'),
    ('izing', 'F'),
    ('oidal', 'A'),
    ('oides', 'A'),
    ('otide', 'A'),
    ('ously', 'A'),
    ('able', 'A'),
    ('ably', 'A'),
    ('ages', 'B'),
    ('ally', 'B'),
    ('ance', 'B'),
    ('ancy', 'B'),
    ('ants', 'B'),
    ('aric', 'A'),
    ('arly', 'K'),
    ('ated', 'I'),
    ('ates', 'A'),
    ('atic', 'B'),
    ('ator', 'A'),
    ('ealy', 'Y'),
    ('edly', 'E'),
    ('eful', 'A'),
    ('eity', 'A'),
    ('ence', 'A'),
    ('ency', 'A'),
    ('ened', 'E'),
    ('enly', 'E'),
    ('eous', 'A'),
    ('hood', 'A'),
    ('ials', 'A'),
    ('ians', 'A'),
    ('ible', 'A'),
    ('ibly', 'A'),
    ('ical', 'A'),
    ('ides', 'L'),
    ('iers', 'A'),
    ('iful', 'A'),
    ('ines', 'M'),
    ('ings', 'N'),
    ('ions', 'B'),
    ('ious', 'A'),
    ('isms', 'B'),
    ('ists', 'A'),
    ('itic', 'H'),
    ('ized', 'F'),
    ('izer', 'F'),
    ('less', 'A'),
    ('lily', 'A'),
    ('ness', 'A'),
    ('ogen', 'A'),
    ('ward', 'A'),
    ('wise', 'A'),
    ('ying', 'B'),
    ('yish', 'A'),
    ('acy', 'A'),
    ('age', 'B'),
    ('aic', 'A'),
    ('als', 'BB'),
    ('ant', 'B'),
    ('ars', 'O'),
    ('ary', 'F'),
    ('ata', 'A'),
    ('ate', 'A'),
    ('eal', 'Y'),
    ('ear', 'Y'),
    ('ely', 'E'),
    ('ene', 'E'),
    ('ent', 'C'),
    ('ery', 'E'),
    ('ese', 'A'),
    ('ful', 'A'),
    ('ial', 'A'),
    ('ian', 'A'),
    ('ics', 'A'),
    ('ide', 'L'),
    ('ied', 'A'),
    ('ier', 'A'),
    ('ies', 'P'),
    ('ily', 'A'),
    ('ine', 'M'),
    ('ing', 'N'),
    ('ion', 'Q'),
    ('ish', 'C'),
    ('ism', 'B'),
    ('ist', 'A'),
    ('ite', 'AA'),
    ('ity', 'A'),
    ('ium', 'A'),
    ('ive', 'A'),
    ('ize', 'F'),
    ('oid', 'A'),
    ('one', 'R'),
    ('ous', 'A'),
    ('ae', 'A'),
    ('al', 'BB'),
    ('ar', 'X'),
    ('as', 'B'),
    ('ed', 'E'),
    ('en', 'F'),
    ('es', 'E'),
    ('ia', 'A'),
    ('ic', 'A'),
    ('is', 'A'),
    ('ly', 'B'),
    ('on', 'S'),
    ('or', 'T'),
    ('um', 'U'),
    ('us', 'V'),
    ('yl', 'R'),
    ("'s", 'A'),
    ("s'", 'A'),
    ('a', 'A'),
    ('e', 'A'),
    ('i', 'A'),
    ('o', 'A'),
    ('s', 'W'),
    ('y', 'B'),
)


# ---------------------------------------------------------------------------
# lovins (lovins.sbl, Lovins 1968): 294 endings with per-ending conditions
# A..CC (among-function form: a failed condition BACKTRACKS to shorter
# endings), then undouble, then respell
# ---------------------------------------------------------------------------

def _lovins_cond(code: str, w: str, c: int) -> bool:
    """Condition at cursor c (= stem length after removing the ending)."""
    last = w[c - 1] if c >= 1 else ""
    if code == "A":
        return c >= 2
    if code == "B":
        return c >= 3
    if code == "C":
        return c >= 4
    if code == "D":
        return c >= 5
    if code == "E":
        return c >= 2 and last != "e"
    if code == "F":
        return c >= 3 and last != "e"
    if code == "G":
        return c >= 3 and last == "f"
    if code == "H":
        return c >= 2 and (last == "t" or w[c - 2: c] == "ll")
    if code == "I":
        return c >= 2 and last not in "oe"
    if code == "J":
        return c >= 2 and last not in "ae"
    if code == "K":
        return c >= 3 and (last in "li"
                           or (last == "e" and w[c - 3] == "u"))
    if code == "L":
        if c < 2 or last in "ux":
            return False
        return not (last == "s" and w[c - 2] != "o")
    if code == "M":
        return c >= 2 and last not in "acem"
    if code == "N":
        # test hop 3; hop 2; (not 's' or hop 2 more)
        return c >= 3 and (w[c - 3] != "s" or c >= 4)
    if code == "O":
        return c >= 2 and last in "li"
    if code == "P":
        return c >= 2 and last != "c"
    if code == "Q":
        return c >= 3 and last not in "ln"
    if code == "R":
        return c >= 2 and last in "nr"
    if code == "S":
        return c >= 2 and (w[c - 2: c] == "dr"
                           or (last == "t" and w[c - 2] != "t"))
    if code == "T":
        return c >= 2 and (last == "s"
                           or (last == "t" and w[c - 2] != "o"))
    if code == "U":
        return c >= 2 and last in "lmnr"
    if code == "V":
        return c >= 2 and last == "c"
    if code == "W":
        return c >= 2 and last not in "su"
    if code == "X":
        return c >= 2 and (last in "li"
                           or (c >= 3 and last == "e" and w[c - 3] == "u"))
    if code == "Y":
        return c >= 2 and w[c - 2: c] == "in"
    if code == "Z":
        return c >= 2 and last != "f"
    if code == "AA":
        return c >= 2 and (last in "dflt" or w[c - 2: c] in
                           ("ph", "th", "er", "or", "es"))
    if code == "BB":
        return c >= 3 and not w[:c].endswith("met") \
            and not w[:c].endswith("ryst")
    if code == "CC":
        return c >= 2 and last == "l"
    raise ValueError(code)


_LOVINS_BY_LEN = sorted(_LOVINS_ENDINGS, key=lambda p: -len(p[0]))

_LOVINS_RESPELL = (
    ("iev", None, "ief"), ("uct", None, "uc"), ("umpt", None, "um"),
    ("rpt", None, "rb"), ("urs", None, "ur"), ("istr", None, "ister"),
    ("metr", None, "meter"), ("olv", None, "olut"),
    ("ul", "aio", "l"), ("bex", None, "bic"), ("dex", None, "dic"),
    ("pex", None, "pic"), ("tex", None, "tic"), ("ax", None, "ac"),
    ("ex", None, "ec"), ("ix", None, "ic"), ("lux", None, "luc"),
    ("uad", None, "uas"), ("vad", None, "vas"), ("cid", None, "cis"),
    ("lid", None, "lis"), ("erid", None, "eris"), ("pand", None, "pans"),
    ("end", "s", "ens"), ("ond", None, "ons"), ("lud", None, "lus"),
    ("rud", None, "rus"), ("her", "pt", "hes"), ("mit", None, "mis"),
    ("ent", "m", "ens"), ("ert", None, "ers"), ("et", "n", "es"),
    ("yt", None, "ys"), ("yz", None, "ys"),
)


def stem_lovins(word: str) -> str:
    w = word
    # endings: longest ending whose condition holds (conditions backtrack)
    for ending, code in _LOVINS_BY_LEN:
        if w.endswith(ending):
            c = len(w) - len(ending)
            if _lovins_cond(code, w, c):
                w = w[:c]
                break
    # undouble
    if w[-2:] in ("bb", "dd", "gg", "ll", "mm", "nn", "pp", "rr", "ss",
                  "tt"):
        w = w[:-1]
    # respell (switch form: a failed inner condition means no respell)
    best = None
    for suf, notpre, repl in _LOVINS_RESPELL:
        if (best is None or len(suf) > len(best[0])) and w.endswith(suf):
            best = (suf, notpre, repl)
    if best is not None:
        suf, notpre, repl = best
        c = len(w) - len(suf)
        if not (notpre and c >= 1 and w[c - 1] in notpre):
            w = w[:c] + repl
    return w


EXTRA_STEMMERS_2["lovins"] = stem_lovins


# ---------------------------------------------------------------------------
# kraaij_pohlmann (kraaij_pohlmann.sbl, Kraaij & Pohlmann's Dutch
# stemmer): y-marking, ij-aware syllable measure, 4 suffix steps with
# vowel lengthening ("lop" -> "loop") and attach-backs, ge- prefix/infix
# removal with re-measure, consonant undoubling and v/z devoicing
# ---------------------------------------------------------------------------

_KP_V = "aeiouy"
_KP_VWX = "aeiouywx"


def _kp_measure(w: str) -> tuple[int, int]:
    n = len(w)
    p1 = p2 = n

    def syllable(c):
        while c < n and w[c] not in _KP_V:
            c += 1
        cnt = 0
        while c < n:
            if w[c: c + 2] == "ij":
                c += 2
                cnt += 1
            elif w[c] in _KP_V:
                c += 1
                cnt += 1
            else:
                break
        if cnt >= 1 and c < n:
            return c + 1
        return None

    c = syllable(0)
    if c is not None:
        p1 = c
        c = syllable(c)
        if c is not None:
            p2 = c
    return p1, p2


def _kp_C(w, c):
    """test(not 'ij' non-v)."""
    return not w[:c].endswith("ij") and c >= 1 and w[c - 1] not in _KP_V


def _kp_V(w, c):
    return (c >= 1 and w[c - 1] in _KP_V) or w[:c].endswith("ij")


def _kp_VX(w, c):
    return c >= 1 and _kp_V(w, c - 1)


def _kp_lengthen(w: str, c: int) -> str:
    """lengthen_V at cursor c (do-wrapped: never fails)."""
    if c <= 0 or w[c - 1] in _KP_VWX:
        return w
    ket = c - 1
    if ket >= 1 and w[ket - 1] in "aou":
        bra = ket - 1
        if bra == 0 or w[bra - 1] not in _KP_V:
            return w[:bra] + w[bra] + w[bra:]
        return w
    if ket >= 1 and w[ket - 1] == "e":
        bra = ket - 1
        if bra == 0:
            c4 = 0
        elif w[bra - 1] not in _KP_V:
            c4 = bra - 1
        else:
            return w
        if c4 >= 1 and w[c4 - 1] in "aiou":
            return w
        if c4 >= 3 and w[c4 - 2] in "aiou" and w[c4 - 3] not in _KP_V:
            return w
        return w[:bra] + "e" + w[bra:]
    return w


def _kp_step1(w, p1, p2):
    n = len(w)
    s = _longest_suffix(w, 0, ("'s", "s", "ies", "es", "aus", "en", "nde"))
    if s is None:
        return w, False
    c = n - len(s)
    if s == "'s":
        return w[:c], True
    if s == "s":
        if c >= p1 and not (c >= 1 and w[c - 1] == "t" and c - 1 >= p1) \
                and _kp_C(w, c):
            return w[:c], True
        return w, False
    if s == "ies":
        if c >= p1:
            return w[:c] + "ie", True
        return w, False
    if s == "es":
        if w[c - 2: c] == "ar" and c - 2 >= p1 and _kp_C(w, c - 2):
            return _kp_lengthen(w[: c - 2], c - 2), True
        if w[c - 2: c] == "er" and c - 2 >= p1 and _kp_C(w, c - 2):
            return w[: c - 2], True
        if c >= p1 and _kp_C(w, c):
            return w[:c] + "e", True
        return w, False
    if s == "aus":
        if c >= p1 and _kp_V(w, c):
            return w[:c] + "au", True
        return w, False
    if s == "en":
        if w[c - 3: c] == "hed" and c - 3 >= p1:
            return w[: c - 3] + "heid", True
        if w[c - 2: c] == "nd":
            return w[:c], True
        if c >= 1 and w[c - 1] == "d" and c - 1 >= p1 and _kp_C(w, c - 1):
            return w[: c - 1], True
        if c >= 1 and w[c - 1] in "ij" and _kp_V(w, c - 1):
            return w[:c], True
        if c >= p1 and _kp_C(w, c):
            return _kp_lengthen(w[:c], c), True
        return w, False
    # 'nde'
    return w[:c] + "nd", True


def _kp_step2(w, p1, p2):
    n = len(w)
    s = _longest_suffix(w, 0, ("je", "ge", "lijke", "ische", "de", "te",
                               "se", "re", "le", "ene", "ieve"))
    if s is None:
        return w, False
    c = n - len(s)
    if s == "je":
        if w[c - 2: c] == "'t":
            return w[: c - 2], True
        if w[c - 2: c] == "et" and c - 2 >= p1 and _kp_C(w, c - 2):
            return w[: c - 2], True
        if w[c - 3: c] == "rnt":
            return w[: c - 3] + "rn", True
        if c >= 1 and w[c - 1] == "t" and c - 1 >= p1 and _kp_VX(w, c - 1):
            return w[: c - 1], True
        if w[c - 3: c] == "ink":
            return w[: c - 3] + "ing", True
        if w[c - 2: c] == "mp":
            return w[: c - 2] + "m", True
        if c >= 1 and w[c - 1] == "'" and c - 1 >= p1:
            return w[: c - 1], True
        if c >= p1 and _kp_C(w, c):
            return w[:c], True
        return w, False
    if s == "ge":
        return (w[:c] + "g", True) if c >= p1 else (w, False)
    if s == "lijke":
        return (w[:c] + "lijk", True) if c >= p1 else (w, False)
    if s == "ische":
        return (w[:c] + "isch", True) if c >= p1 else (w, False)
    if s == "de":
        return (w[:c], True) if c >= p1 and _kp_C(w, c) else (w, False)
    if s == "te":
        return (w[:c] + "t", True) if c >= p1 else (w, False)
    if s == "se":
        return (w[:c] + "s", True) if c >= p1 else (w, False)
    if s == "re":
        return (w[:c] + "r", True) if c >= p1 else (w, False)
    if s == "le":
        if c >= p1:
            # attach advances the cursor past the attached text
            return _kp_lengthen(w[:c] + "l", c + 1), True
        return w, False
    if s == "ene":
        if c >= p1 and _kp_C(w, c):
            return _kp_lengthen(w[:c] + "en", c + 2), True
        return w, False
    # 'ieve'
    return (w[:c] + "ief", True) if c >= p1 and _kp_C(w, c) else (w, False)


def _kp_step3(w, p1, p2):
    n = len(w)
    s = _longest_suffix(w, 0, ("atie", "iteit", "heid", "sel", "ster",
                               "rder", "ing", "isme", "erij", "arij",
                               "fie", "gie", "tst", "dst"))
    if s is None:
        return w, False
    c = n - len(s)
    if s == "atie":
        return (w[:c] + "eer", True) if c >= p1 else (w, False)
    if s == "iteit":
        return (_kp_lengthen(w[:c], c), True) if c >= p1 else (w, False)
    if s in ("heid", "sel", "ster"):
        return (w[:c], True) if c >= p1 else (w, False)
    if s == "rder":
        return w[:c] + "r", True
    if s in ("ing", "isme", "erij"):
        return (_kp_lengthen(w[:c], c), True) if c >= p1 else (w, False)
    if s == "arij":
        return (w[:c] + "aar", True) if c >= p1 and _kp_C(w, c) \
            else (w, False)
    if s in ("fie", "gie"):
        if c >= p2:
            # attach advances the cursor past the attached text
            return _kp_lengthen(w[:c] + s[0], c + 1), True
        return w, False
    # 'tst' / 'dst'
    return (w[:c] + s[0], True) if c >= p1 and _kp_C(w, c) else (w, False)


def _kp_step4(w, p1, p2):
    n = len(w)
    s = _longest_suffix(w, 0, ("ioneel", "atief", "baar", "naar", "laar",
                               "raar", "tant", "lijker", "lijkst",
                               "achtig", "achtiger", "achtigst", "eriger",
                               "erigst", "erig", "end"))
    ok = False
    if s is not None:
        c = n - len(s)
        if s == "ioneel":
            if c >= p1:
                return w[:c] + "ie", True
        elif s == "atief":
            if c >= p1:
                return w[:c] + "eer", True
        elif s == "baar":
            if c >= p1:
                return w[:c], True
        elif s in ("naar", "laar", "raar"):
            if c >= p1 and _kp_V(w, c):
                return w[:c] + s[0], True
        elif s == "tant":
            if c >= p1:
                return w[:c] + "teer", True
        elif s in ("lijker", "lijkst"):
            if c >= p1:
                return w[:c] + "lijk", True
        elif s in ("achtig", "achtiger", "achtigst"):
            if c >= p1:
                return w[:c], True
        else:                                # eriger/erigst/erig/end
            if c >= p1 and _kp_C(w, c):
                return _kp_lengthen(w[:c], c), True
    # second among only when the first fails
    s = _longest_suffix(w, 0, ("iger", "igst", "ig"))
    if s is not None:
        c = n - len(s)
        if c >= p1 and _kp_C(w, c):
            return _kp_lengthen(w[:c], c), True
    return w, ok


def _kp_step7(w):
    for suf, repl in (("kt", "k"), ("ft", "f"), ("pt", "p")):
        if w.endswith(suf):
            return w[: -2] + repl, True
    return w, False


def _kp_step6(w):
    if len(w) >= 2 and w[-1] == w[-2] and w[-1] in "bcdfghjklmnpqrstvwxz":
        return w[:-1], True
    if w.endswith("v"):
        return w[:-1] + "f", True
    if w.endswith("z"):
        return w[:-1] + "s", True
    return w, False


def _kp_step1c(w, p1):
    n = len(w)
    for s in ("d", "t"):
        if w.endswith(s):
            c = n - 1
            if c >= p1 and _kp_C(w, c):
                guard = "n" if s == "d" else "h"
                if not (c >= 1 and w[c - 1] == guard and c - 1 >= p1):
                    return w[:c], True
            return w, False                  # among matched; action failed
    return w, False


def _kp_has_v_then_c(w, start):
    """goto v goto non-v from `start` (lowercase v; marked Y excluded)."""
    iv = start
    n = len(w)
    while iv < n and w[iv] not in _KP_V:
        iv += 1
    if iv >= n:
        return False
    k = iv
    while k < n and w[k] in _KP_V:
        k += 1
    return k < n


def stem_kraaij_pohlmann(word: str) -> str:
    w = word
    y_found = False
    if w.startswith("y"):
        w = "Y" + w[1:]
        y_found = True
    chars = list(w)
    for i in range(len(chars) - 1):
        if chars[i] in _KP_V and chars[i + 1] == "y":
            chars[i + 1] = "Y"
            y_found = True
    w = "".join(chars)

    p1, p2 = _kp_measure(w)
    stemmed = False
    for step in (_kp_step1, _kp_step2, _kp_step3, _kp_step4):
        w, ok = step(w, p1, p2)
        stemmed = stemmed or ok

    # Lose_prefix and measure; then Step_1c if removed
    ge_removed = False
    if w.startswith("ge") and len(w) - 2 >= 3 and _kp_has_v_then_c(w, 2):
        w = w[2:]
        ge_removed = True
        p1, p2 = _kp_measure(w)
    if ge_removed:
        w, _ = _kp_step1c(w, p1)

    # Lose_infix and measure; then Step_1c if removed
    ge_removed = False
    g = w.find("ge", 1)
    if g >= 1 and len(w) - (g + 2) >= 3 and _kp_has_v_then_c(w, g + 2):
        w = w[:g] + w[g + 2:]
        ge_removed = True
        p1, p2 = _kp_measure(w)
    if ge_removed:
        w, _ = _kp_step1c(w, p1)

    w, ok7 = _kp_step7(w)
    stemmed = stemmed or ok7
    if stemmed or ge_removed:
        w, _ = _kp_step6(w)

    if y_found:
        w = w.replace("Y", "y")
    return w


EXTRA_STEMMERS_2["kraaij_pohlmann"] = stem_kraaij_pohlmann
