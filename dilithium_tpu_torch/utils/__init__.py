"""Host-side helpers: the KAT corpus loader (`kat`)."""
