"""The benchmark's plain reference: each document's text worked out
again from the event log the benchmark generated and the peer ids it
gave the document, by a walk of the Fugue tree.  It imports nothing of
the program and takes nothing the program made."""
