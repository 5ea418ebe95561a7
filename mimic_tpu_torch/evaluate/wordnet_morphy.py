"""Vendored WordNet morphy verb lemmatization (exact NLTK algorithm).

The reference OKVQA stemmer lemmatizes ``-ing`` tokens with
``nltk.stem.WordNetLemmatizer().lemmatize(w, VERB)``
(``testbed/data/ok_vqa/__init__.py:188-206``), which is:

    lemmas = WordNetCorpusReader._morphy(word, "v")   # rules + exc + index
    return min(lemmas, key=len) if lemmas else word   # shortest lemma wins

WordNet's corpus data files are not shipped with this package, so
this module vendors the three inputs that algorithm needs and reimplements the
algorithm EXACTLY (``nltk/corpus/reader/wordnet.py::_morphy`` — apply every
suffix rule once, try the exception list first, filter every candidate plus
the original form by the verb lemma index, preserve candidate order, dedup):

- ``MORPHOLOGICAL_SUBSTITUTIONS_VERB`` — WordNet's verb detachment-rule table,
  vendored from the installed NLTK source and mechanically diffed against it
  by ``tests/test_wordnet_morphy_parity.py`` (fails if NLTK's table differs);
- ``VERB_EXC`` — verb.exc-format exception entries ("inflected lemma" lines,
  WordNet 3.x) for the gerund/irregular vocabulary the VQA pipeline meets:
  doubled-consonant gerunds (running→run) and y-inflected irregulars
  (lying→lie) that the rules cannot recover;
- ``VERB_INDEX`` — the restriction of WordNet's index.verb to the lemmas
  reachable from the project's closed answer vocabulary.

Algorithm-level equivalence with NLTK is a *machine-checked theorem*, not a
reading of its source: the parity test instantiates NLTK's real
``WordNetCorpusReader`` with these tables injected and runs its actual
``_morphy`` byte-compiled code against ours over the full closure vocabulary
plus thousands of fuzz-generated strings.  The remaining trust boundary is the
DATA: ``VERB_EXC``/``VERB_INDEX`` are a vendored subset of WordNet, so words
outside the vendored vocabulary fall back to "unchanged" where full WordNet
might still find a lemma.  That divergence class is documented in
``tests/test_okvqa_stem_closure.py`` and confined to out-of-vocabulary tokens.

NLTK version assumption: parity is machine-checked against the INSTALLED NLTK
(3.10), whose ``_morphy`` applies the detachment rules in a single pass.  The
reference pins ``nltk==3.9.1`` (its ``requirements.txt``), which
was not at hand to confirm its ``_morphy`` body is
identical; if 3.9.1 retained an older iterative multi-pass rule loop,
out-of-vocabulary multi-pass forms (e.g. "seeding") could lemmatize
differently.  Any such divergence is confined to the already-documented
out-of-vocabulary trust boundary above — verify 3.9.1's ``_morphy`` matches
when that version is at hand.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# WordNet verb detachment rules, in WordNet's order (order matters: candidates
# are generated rule-by-rule and ``min(..., key=len)`` takes the FIRST of the
# shortest).  Vendored from nltk/corpus/reader/wordnet.py
# ``MORPHOLOGICAL_SUBSTITUTIONS[VERB]``; the parity test diffs this against the
# installed NLTK attribute.
MORPHOLOGICAL_SUBSTITUTIONS_VERB: List[Tuple[str, str]] = [
    ("s", ""),
    ("ies", "y"),
    ("es", "e"),
    ("es", ""),
    ("ed", "e"),
    ("ed", ""),
    ("ing", "e"),
    ("ing", ""),
]

# verb.exc-format entries (WordNet 3.x "inflected lemma" lines).  Only
# inflections the detachment rules cannot recover need entries: consonant
# doubling (running → runn/runne by rule, neither a lemma) and -y irregulars.
_VERB_EXC_LINES = """\
banning ban
barring bar
batting bat
begging beg
betting bet
bidding bid
blogging blog
bobbing bob
bragging brag
budding bud
bugging bug
chatting chat
chopping chop
clapping clap
clipping clip
cramming cram
cropping crop
cutting cut
digging dig
dipping dip
dotting dot
dragging drag
dribbling dribble
dripping drip
dropping drop
drumming drum
fitting fit
flapping flap
flipping flip
fogging fog
getting get
grabbing grab
grinning grin
gripping grip
hemming hem
hitting hit
hopping hop
hugging hug
humming hum
jamming jam
jogging jog
knitting knit
letting let
mopping mop
mugging mug
napping nap
netting net
nodding nod
patting pat
pegging peg
petting pet
pinning pin
planning plan
plotting plot
plugging plug
popping pop
petting pet
putting put
quitting quit
rapping rap
ribbing rib
ripping rip
robbing rob
rubbing rub
running run
scanning scan
scrubbing scrub
setting set
shipping ship
shopping shop
shredding shred
shrugging shrug
shutting shut
sipping sip
sitting sit
skidding skid
skimming skim
skinning skin
skipping skip
slamming slam
slapping slap
sledding sled
slipping slip
snapping snap
sobbing sob
spanning span
spinning spin
spitting spit
splitting split
spotting spot
stabbing stab
stepping step
stirring stir
stopping stop
strapping strap
strumming strum
stunning stun
submitting submit
swimming swim
tagging tag
tanning tan
tapping tap
thinning thin
throbbing throb
tipping tip
topping top
trapping trap
trekking trek
trimming trim
tripping trip
trotting trot
tugging tug
wagging wag
wedding wed
whipping whip
winning win
wrapping wrap
zipping zip
lying lie
dying die
tying tie
vying vie
being be
""".strip()

VERB_EXC: Dict[str, List[str]] = {}
for _line in _VERB_EXC_LINES.splitlines():
    _parts = _line.split()
    VERB_EXC.setdefault(_parts[0], [])
    for _lemma in _parts[1:]:
        if _lemma not in VERB_EXC[_parts[0]]:
            VERB_EXC[_parts[0]].append(_lemma)

# Restriction of WordNet's index.verb to the lemmas reachable from the VQA
# closure vocabulary (base verbs whose inflections the pipeline can meet, plus
# -ing-final base verbs that must survive unchanged, e.g. "spring").
#
# Short verbs like hop/tap/wag/cop/rag/mat/pip/kit/par/wad/strip ARE WordNet
# verb lemmas, and because ``lemmatize`` takes the SHORTEST candidate they win
# over the -e restorations (hoping → hop, not hope).  The reference's own
# MANUAL_MATCHES table corroborates this: entries such as mating→mate,
# plating→plate, piping→pipe, kiting→kite, paring→pare, wading→wade exist
# precisely because the automatic pipeline returned the min-length artifacts
# mat/plat/pip/kit/par/wad and the OKVQA release hand-corrected them — words
# absent from that table (hoping, taping, waging, …) keep the min-length
# behavior, and so do we.
VERB_INDEX = frozenset("""
achieve adore announce angle approve argue arrange bake bale balance bat bathe
be beg behave believe bet bid bike binge blaze board bob bounce bowl brag brake
breathe bridge bring browse brush build cage can care carve catch cage change
charge chase chat choke chop clap clean climb cling close come compile continue
cook cop cope crave cringe crop cross cure curve cut cycle dance deserve die
dig dip dive divorce do dodge dot doze drag draw dribble drink drip drive drop
drum eat edge engage escape even evolve exchange explore fade fall feed fence
fight file fill fire fish fit flap fling flip fly force freeze fry gamble gaze
get give glance glare glide glue go grab graze grieve grill grin grip hang
have herd hide hike hinge hire hit hold hop hope hug hum hunt ice ignore
improve introduce involve issue jam jog joke judge juggle juice jump kayak
kick kiss knit land laugh lead leave let lie live load long look lounge lunge
lure manage make measure merge milk mop move mug nap net nod nudge observe
paddle page paint par park paste pat pave peg pet pierce pile pin pitch place
plan play plot plug plunge point poke pop pore pose pour prance preserve
price produce pronounce prove pull pursue put quit race rage rain rake rap
reach read receive recycle reduce relieve remove rescue reserve rest retrieve
revolve rib ride rile ring rip rise rob roll row rub rule run sail sauce save
say scale scan schedule score scrape scrub see serve set shake shape share
shave ship shop show shred shrug shut sing singe sip sit skate skateboard ski
skid skim skin skip sled sleep slice slide sling slip smile smoke smuggle
snap snore snooze snow snowboard snuggle sob solve space span sparkle spell
spin spit splice split sponge spot spring squeeze stab stage stand stare
starve step sting stir stop store strap string stroke struggle strum stun
style submit sue surf surge swerve swim swing tag take talk tan tap tape
taste throb throw tie tile tip tire top tour trace trade trap trek trim trip
trot tug urge use value wade wag wage wait wake walk wash waste watch wave
weave wed whale whip whistle win wing work wrap wrestle wring write zip
vie shine belong ping sneeze wire range queue baste ceil rag stag bath
mat plat pip kit wad strip purr dine
""".split())


def morphy_verb(form: str) -> List[str]:
    """Exact reimplementation of NLTK ``WordNetCorpusReader._morphy(form, 'v')``
    over the vendored tables (same candidate generation, order, and dedup)."""
    substitutions = MORPHOLOGICAL_SUBSTITUTIONS_VERB

    def apply_rules(forms):
        return [
            f[: -len(old)] + new
            for f in forms
            for old, new in substitutions
            if f.endswith(old)
        ]

    def filter_forms(forms):
        result = []
        seen = set()
        for f in forms:
            if f in VERB_INDEX and f not in seen:
                result.append(f)
                seen.add(f)
        return result

    if form in VERB_EXC:
        forms = VERB_EXC[form]
    else:
        forms = apply_rules([form])
    return filter_forms([form] + forms)


def lemmatize_verb(word: str) -> str:
    """Exact NLTK ``WordNetLemmatizer.lemmatize(word, 'v')``: shortest lemma
    among the morphy candidates, the word itself if there are none."""
    lemmas = morphy_verb(word)
    return min(lemmas, key=len) if lemmas else word
