"""The port's host library: the C prepare and walk of match_many
(prepare.cc, walker.cc), the compiler's reach builder (reach.cc) and
their build."""
