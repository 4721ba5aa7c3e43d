"""Stopword lists for the fulltext tokenizer (analog of tok/stopwords.go,
which bundles bleve's per-language lists; we ship English and a small set
for common languages — unknown languages fall back to English)."""

STOPWORDS = {
    "en": frozenset(
        """a an and are as at be but by for if in into is it no not of on
        or such that the their then there these they this to was will with
        i me my we our you your he him his she her its them what which who
        whom am been being have has had having do does did doing would
        should could can cannot don t s""".split()
    ),
    "de": frozenset(
        """der die das ein eine und oder aber nicht mit von zu im in auf
        für ist sind war waren sein als auch an bei nach über um aus""".split()
    ),
    "fr": frozenset(
        """le la les un une des et ou mais ne pas avec de du au aux est
        sont était dans sur pour par ce cette ces il elle ils elles""".split()
    ),
    "es": frozenset(
        """el la los las un una unos unas y o pero no con de del al es son
        era en sobre para por este esta estos estas él ella ellos""".split()
    ),
    "it": frozenset(
        """il lo la i gli le un uno una e o ma non con di del della al
        alla in su per da è sono era questo questa questi queste""".split()
    ),
    "pt": frozenset(
        """o a os as um uma uns umas e ou mas não com de do da dos das no
        na em sobre para por este esta estes estas é são era ele ela""".split()
    ),
    "nl": frozenset(
        """de het een en of maar niet met van te in op voor is zijn was
        waren als ook aan bij naar over om uit dit dat deze die""".split()
    ),
    "ru": frozenset(
        """и в во не что он на я с со как а то все она так его но да ты к
        у же вы за бы по ее мне было вот от меня еще нет о из ему""".split()
    ),
    "sv": frozenset(
        """och det att i en jag hon som han på den med var sig för så
        till är men ett om hade de av icke mig du henne då sin nu""".split()
    ),
    "da": frozenset(
        """og i jeg det at en den til er som på de med han af for ikke
        der var mig sig men et har om vi min havde ham hun nu""".split()
    ),
    "no": frozenset(
        """og i jeg det at en et den til er som på de med han av ikke
        der så var meg seg men ett har om vi min mitt ha hadde hun nå""".split()
    ),
    "hu": frozenset(
        """a az és hogy nem is egy de meg ez el volt ha mint csak már
        még vagy ki mi fel be ő őt aki ami ezek azok""".split()
    ),
    "ro": frozenset(
        """și în a la cu de pe un o este sunt era nu se ce care mai dar
        pentru din sau fi el ea ei ele acest această""".split()
    ),
    "fi": frozenset(
        """ja on ei se että en hän oli mutta niin kun myös joka mikä
        tai jos sitä ole nyt vain kuin mitä siis me he""".split()
    ),
    "tr": frozenset(
        """ve bir bu da de için ile mi ne o ki gibi daha çok en az ama
        ya hem şu ben sen biz siz onlar değil var yok""".split()
    ),
}
