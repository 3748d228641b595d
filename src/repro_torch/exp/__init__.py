"""Port of `repro.exp`, so far only the problems of BL1's main path
(`problems`).  The registry, sweep engine and artifact writer come with
ROADMAP.md §1 item 11."""
