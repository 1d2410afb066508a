"""Traffic generators: each makes the inputs of one kind of traffic mix
from the seed and drives the program with them (``prepare``, ``warm``,
``measure``, ``compare``)."""
