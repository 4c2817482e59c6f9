"""The benchmark's yardstick: the plain float32 reference of the models
(``model``), the seeded weights and clips both sides are given
(``weights``), and the frozen work counters (``work``). Nothing here
imports the program it judges."""
