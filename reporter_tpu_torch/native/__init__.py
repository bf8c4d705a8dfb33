"""The port's host library: the C prepare and walk of match_many
(prepare.cc, walker.cc) and their build."""
