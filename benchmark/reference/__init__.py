"""The plain reference of bgreat's greedy mapper (`graph`, `model`,
`seq`) and the comparison that decides `correct` (`check`)."""

MODES = ("greedy",)     # the configurations' modes this package judges
